"""Dispatch between the CUDA kernels and their plain versions.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, which raises if it cannot build or launch — there is no fallback.
``dispatch_counts`` tallies each decision under ``"<kernel>.kernel"`` or
``"<kernel>.plain"`` (as ``repro/kernels/ops.py`` does), adding one to
``.kernel`` exactly where a kernel is launched, so a run can prove which
path it took. Calling a kernel module's ``launch`` directly (as a
comparison does) is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import chunk_l1norm as _cl
from repro_torch.kernels import csc_compact as _cc
from repro_torch.kernels import pool_pack as _pp
from repro_torch.kernels import pool_unpack as _pu
from repro_torch.kernels import ref

dispatch_counts: Dict[str, int] = {}


def _count(name: str, path: str) -> None:
    key = f"{name}.{path}"
    dispatch_counts[key] = dispatch_counts.get(key, 0) + 1


def reset_counts() -> None:
    dispatch_counts.clear()


def _on_cuda(tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed devices {sorted(kinds)}")


def chunk_l1norm(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Per-chunk f32 L1 norms of the pool: (C*chunk,) -> f32[C]."""
    if not _on_cuda([pool]):
        _count("chunk_l1norm", "plain")
        return _cl.plain(pool, chunk_elems)
    _count("chunk_l1norm", "kernel")
    return _cl.launch(pool, chunk_elems)


def csc_compact(pool: torch.Tensor, idx: torch.Tensor,
                chunk_elems: int) -> torch.Tensor:
    """The selected chunks gathered into the dense wire buffer:
    (C*chunk,), idx (k,) -> (k*chunk,)."""
    if not _on_cuda([pool, idx]):
        _count("csc_compact", "plain")
        return _cc.plain(pool, idx, chunk_elems)
    _count("csc_compact", "kernel")
    return _cc.launch(pool, idx, chunk_elems)


def pool_pack(leaves: Sequence[torch.Tensor], offsets: Tuple[int, ...],
              sizes: Tuple[int, ...], pool_size: int, chunk_elems: int,
              wire_dtype: torch.dtype, out: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused ravel + wire cast + chunk-L1 census over the gradient pool.
    Returns (wire pool, norms or None). A staging buffer ``out`` is in the
    wire dtype, written in place and returned as the pool."""
    if not leaves or not _on_cuda(list(leaves) + [out]):
        _count("pool_pack", "plain")
        return ref.pool_pack(leaves, offsets, pool_size, chunk_elems,
                             wire_dtype, out=out)
    _count("pool_pack", "kernel")
    return _pp.launch(leaves, offsets, sizes, pool_size, chunk_elems,
                      wire_dtype, out=out)


def pool_unpack_update(master, grads, momentum_buf, mask,
                       offsets: Tuple[int, ...], sizes: Tuple[int, ...], *,
                       lr, momentum: float, weight_decay: float,
                       scale: Optional[torch.Tensor] = None,
                       ratios: Optional[torch.Tensor] = None,
                       out_leaves: Optional[Sequence[torch.Tensor]] = None,
                       out_momentum: Optional[torch.Tensor] = None,
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Fused momentum-SGD update + unpack of one pool span. Returns
    (leaves, new momentum), written into ``out_leaves`` / ``out_momentum``
    when given (see ``pool_unpack`` for the in-place contract)."""
    tensors = [master, grads, momentum_buf, mask, scale, ratios,
               out_momentum] + list(out_leaves or [])
    if not _on_cuda(tensors):
        _count("pool_unpack_update", "plain")
        fn = _pu.plain
    else:
        _count("pool_unpack_update", "kernel")
        fn = _pu.launch
    return fn(master, grads, momentum_buf, mask, offsets, sizes, lr=lr,
              momentum=momentum, weight_decay=weight_decay, scale=scale,
              ratios=ratios, out_leaves=out_leaves,
              out_momentum=out_momentum)

"""Dispatch between the CUDA kernels and their plain versions.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, which raises if it cannot build or launch — there is no fallback.
``dispatch_counts`` tallies each decision under ``"<kernel>.kernel"`` or
``"<kernel>.plain"`` (as ``repro/kernels/ops.py`` does), adding one to
``.kernel`` exactly where a kernel is launched, so a run can prove which
path it took. Calling a kernel module's ``launch`` directly (as a
comparison does) is not counted. ``dispatch_counts`` is the ``dispatch``
group of ``runtime.trace.counters``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import chunk_l1norm as _cl
from repro_torch.kernels import csc_compact as _cc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import pool_pack as _pp
from repro_torch.kernels import pool_unpack as _pu
from repro_torch.kernels import ref
from repro_torch.kernels import ring_reduce as _rr
from repro_torch.runtime import trace

dispatch_counts: Dict[str, int] = trace.counters["dispatch"]


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
                       ok: Optional[torch.Tensor] = None,
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Fused momentum-SGD update + unpack of one pool span. Returns
    (leaves, new momentum), written into ``out_leaves`` / ``out_momentum``
    when given (see ``pool_unpack`` for the in-place contract). ``ok``:
    the guard's device verdict; when false nothing is written."""
    tensors = [master, grads, momentum_buf, mask, scale, ratios,
               out_momentum, ok] + list(out_leaves or [])
    if not _on_cuda(tensors):
        _count("pool_unpack_update", "plain")
        fn = _pu.plain
    else:
        _count("pool_unpack_update", "kernel")
        fn = _pu.launch
    return fn(master, grads, momentum_buf, mask, offsets, sizes, lr=lr,
              momentum=momentum, weight_decay=weight_decay, scale=scale,
              ratios=ratios, out_leaves=out_leaves,
              out_momentum=out_momentum, ok=ok)


def fused_update(master, grads, momentum_buf, mask, *, lr, momentum: float,
                 weight_decay: float, scale: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked momentum-SGD step over a whole pool: (new master, new
    momentum)."""
    if not _on_cuda([master, grads, momentum_buf, mask, scale]):
        _count("fused_update", "plain")
        fn = _fu.plain
    else:
        _count("fused_update", "kernel")
        fn = _fu.launch
    return fn(master, grads, momentum_buf, mask, lr=lr, momentum=momentum,
              weight_decay=weight_decay, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of q, k, v (b, s, h, hd) -> o (b, s, h, hd)
    through the kernels, differentiable, its backward rebuilding P from
    the forward's log-sum-exp; counted once a forward launch. Raises on
    what the kernels do not take, CPU tensors included (``attend`` keeps
    full and blockwise attention there)."""
    # Counted before the launch: a remat recompute that stops early
    # (``torch.utils.checkpoint``) leaves the call once the forward has
    # launched and saved its tensors.
    _fa.check(q, k, v)
    _count("flash_attention", "kernel")
    return _fa.kernel_attention(q, k, v)


class StreamWork:
    """An issued ring: ``wait()`` makes the current stream wait for it."""

    def __init__(self, event):
        self._event = event

    def wait(self) -> None:
        torch.cuda.current_stream(self._event.device).wait_event(self._event)


_COMM_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def comm_stream(device: torch.device):
    """The stream the rings of ``device`` run on (one per device, so
    rings run in issue order, as every rank issues them)."""
    s = _COMM_STREAMS.get(device.index)
    if s is None:
        s = _COMM_STREAMS[device.index] = torch.cuda.Stream(device)
    return s


def ring_prepare(levels, device) -> None:
    """Set up the ring workspace of every level with more than one rank,
    once per level group (collectively); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        for lg in levels:
            if lg.size > 1:
                _rr.prepare(lg, device)


def ring_allreduce(x: torch.Tensor, levels, wire_dtype=None,
                   async_op: bool = False):
    """Sum ``x`` with one ring per level (``levels``: the
    ``collectives.LevelGroup`` of each level, innermost first), in place.
    Returns ``(x, work)`` like the flat all-reduce.

    A CPU tensor runs the plain twin over each level's process group. A
    CUDA tensor launches the kernel once per level on the device's
    communication stream, after the current stream's work, over the
    level's workspace (``ring_prepare``); with ``async_op`` the returned
    work's ``wait()`` makes the current stream wait for it, else the
    current stream waits at once."""
    levels = [lg for lg in levels if lg.size > 1]
    if not levels:
        return x, None
    if not _on_cuda([x]):
        for lg in levels:
            _count("ring_allreduce", "plain")
            x.copy_(ref.ring_allreduce(x, lg, wire_dtype))
        return x, None
    device = x.device
    cur = torch.cuda.current_stream(device)
    comm = comm_stream(device)
    comm.wait_stream(cur)
    with torch.cuda.stream(comm):
        for lg in levels:
            ws = _rr.workspace(lg, device)
            _count("ring_allreduce", "kernel")
            _rr.launch(x, ws, wire_dtype, out=x)
    x.record_stream(comm)
    event = torch.cuda.Event()
    event.record(comm)
    work = StreamWork(event)
    if async_op:
        return x, work
    work.wait()
    return x, None

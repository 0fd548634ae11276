"""Plain PyTorch versions of the pool kernels.

The semantic ground truth of the port's CUDA kernels, written with the
same arithmetic as the JAX package's ``kernels/ref.py``: the CPU tests run
them against the JAX functions, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card. Every elementwise step is its own op
(no ``alpha=`` or ``addcmul``), so no multiply-add is fused and the CUDA
kernels, which round each step, can match them bit for bit.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch


def result_dtype(tensors: Sequence[torch.Tensor]) -> torch.dtype:
    """The promoted dtype of ``tensors`` (JAX's ``result_type``)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def chunk_l1norm(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Per-chunk L1 norms with f32 accumulation: (C*chunk,) -> (C,)."""
    return pool.reshape(-1, chunk_elems).abs().sum(dim=1,
                                                   dtype=torch.float32)


def csc_compact(pool: torch.Tensor, idx: torch.Tensor,
                chunk_elems: int) -> torch.Tensor:
    """Gather the selected chunks into the dense wire buffer:
    (C*chunk,), idx (k,) -> (k*chunk,)."""
    return torch.index_select(pool.reshape(-1, chunk_elems), 0,
                              idx).reshape(-1)


def pool_pack(
    leaves: Sequence[torch.Tensor],  # 1-D leaves, pool order
    offsets: Sequence[int],
    pool_size: int,
    chunk_elems: int,                # 0 => no census
    wire_dtype: torch.dtype,
    out: Optional[torch.Tensor] = None,  # staging buffer, wire dtype
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Write every leaf into one wire-dtype pool at its offset (``copy_``
    rounds to nearest even), zero what no leaf covers, and optionally take
    the per-chunk L1 census of the wire values. ``out`` is the staging
    buffer, written in place and returned as the pool; without it a new
    pool is made. Returns (wire pool, norms or None)."""
    if out is None:
        device = leaves[0].device if leaves else torch.device("cpu")
        pool = torch.empty((pool_size,), dtype=wire_dtype, device=device)
    else:
        pool = out
    assert pool.shape == (pool_size,) and pool.dtype == wire_dtype, (
        pool.shape, pool.dtype, pool_size, wire_dtype)
    pos = 0
    for x, off in zip(leaves, offsets):
        pool[pos:off].zero_()
        pool[off:off + x.numel()].copy_(x.reshape(-1))
        pos = off + x.numel()
    pool[pos:].zero_()
    norms = chunk_l1norm(pool, chunk_elems) if chunk_elems else None
    return pool, norms


def expand_ratios(ratios: torch.Tensor, sizes: Sequence[int],
                  pool_size: int) -> torch.Tensor:
    """Per-tensor ratios -> per-element scale over the segment table.
    Padding takes the trailing ratio when one is supplied, else 1.0."""
    pad = pool_size - sum(sizes)
    reps = list(sizes)
    if ratios.shape[0] == len(sizes):
        if pad:
            ratios = torch.cat([ratios, ratios.new_ones((1,))])
    else:
        assert ratios.shape[0] == len(sizes) + 1, (ratios.shape, len(sizes))
    if pad:
        reps.append(pad)
    counts = torch.tensor(reps, dtype=torch.int64, device=ratios.device)
    return torch.repeat_interleave(ratios[:len(reps)], counts,
                                   output_size=pool_size)


def update_math(master, grads, mom, mask, lr, *, momentum: float,
                weight_decay: float, scale=None):
    """The masked momentum-SGD step (Algorithm 1), one op per rounding:
    g = grads + wd*master (x scale); u = m*mom + lr*g; masked select of
    (mom -> u) and (master -> master - u). Returns (new_master, new_mom)."""
    g = grads + weight_decay * master
    if scale is not None:
        g = g * scale
    u = momentum * mom + lr * g
    new_mom = torch.where(mask, u, mom)
    new_master = torch.where(mask, master - u, master)
    return new_master, new_mom


def pool_unpack_update(
    master: torch.Tensor,        # f32[n]
    grads: torch.Tensor,         # f32[n]
    momentum_buf: torch.Tensor,  # f32[n]
    mask: torch.Tensor,          # bool[n]
    offsets: Sequence[int],
    sizes: Sequence[int],
    *,
    lr,
    momentum: float,
    weight_decay: float,
    scale: Optional[torch.Tensor] = None,
    ratios: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The update, then slices of the new master per tensor. Returns
    (1-D leaves in segment-table order, new momentum)."""
    assert scale is None or ratios is None, "pass scale OR ratios"
    if ratios is not None:
        scale = expand_ratios(ratios, tuple(sizes), master.shape[0])
    new_master, new_mom = update_math(master, grads, momentum_buf, mask, lr,
                                      momentum=momentum,
                                      weight_decay=weight_decay, scale=scale)
    leaves = [new_master[o:o + s] for o, s in zip(offsets, sizes)]
    return leaves, new_mom

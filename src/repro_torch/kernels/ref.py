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


def commit_where(ok: torch.Tensor, new: Sequence[torch.Tensor],
                 old: Sequence[torch.Tensor]) -> None:
    """Predicated write: each ``old`` tensor takes its ``new`` value where
    the device flag ``ok`` holds and keeps its own bits otherwise (a
    select, so NaNs in a rejected ``new`` never reach it). In place, one
    pass a tensor, no host sync: the plain form of the update kernel's
    ``ok`` predicate, and the guard's commit of state no kernel writes."""
    for n, o in zip(new, old):
        torch.where(ok, n if n.dtype == o.dtype else n.to(o.dtype), o,
                    out=o)


def fused_update(master, grads, momentum_buf, mask, *, lr, momentum: float,
                 weight_decay: float, scale=None):
    """The masked momentum-SGD step over a whole flat pool (the function
    of the ``fused_update`` kernel). Returns (new_master, new_momentum)."""
    return update_math(master, grads, momentum_buf, mask, lr,
                       momentum=momentum, weight_decay=weight_decay,
                       scale=scale)


# -- the ring all-reduce ------------------------------------------------------
#
# Rank d of N, segments of ``seg`` elements over the zero-padded (N*seg,)
# f32 accumulator seeded from x in its own dtype:
#   reduce-scatter, t = 0..N-2: send segment (d-t)%N in the wire dtype to
#     rank d+1, receive segment (d-t-1)%N from rank d-1, add it in f32;
#   rank d now owns segment (d+1)%N, rounded once through the wire dtype;
#   all-gather, t = 0..N-2: send (d+1-t)%N, receive (d-t)%N, overwrite.
# The result is cast to x's dtype and is the same bits on every rank.


def requant(vals: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """f32 accumulator values -> the wire grid. Integer wires (int8)
    round half to even first (``.to`` truncates); float wires (bf16,
    fp8-e4m3) round in the cast itself, with PyTorch's overflow rule."""
    if not wire.is_floating_point:
        vals = torch.round(vals)
    return vals.to(wire)


def ring_seg_elems(n_elems: int, n_ranks: int) -> int:
    """The twin's segment length: ceil(n / N)."""
    return -(-n_elems // n_ranks) if n_elems else 0


def _seeded(x: torch.Tensor, n: int, seg: int) -> torch.Tensor:
    acc = torch.zeros((n * seg,), dtype=torch.float32, device=x.device)
    acc[:x.shape[0]] = x.to(torch.float32)
    return acc


def ring_allreduce_ranks(xs: Sequence[torch.Tensor],
                         wire_dtype: Optional[torch.dtype] = None,
                         seg_elems: Optional[int] = None
                         ) -> List[torch.Tensor]:
    """The ring schedule over N ranks' tensors in one process: returns the
    N results (the same bits). ``wire_dtype`` defaults to x's dtype;
    ``seg_elems`` to ceil(n/N) (the CUDA kernel pads the segment to whole
    sub-tiles and passes its own)."""
    n = len(xs)
    x0 = xs[0]
    if n == 1:
        return [x0]
    wire = wire_dtype or x0.dtype
    size = x0.shape[0]
    seg = seg_elems if seg_elems is not None else ring_seg_elems(size, n)
    assert seg * n >= size, (seg, n, size)
    accs = [_seeded(x, n, seg) for x in xs]

    def sl(i):
        return slice(i * seg, (i + 1) * seg)

    for t in range(n - 1):
        sent = [requant(accs[d][sl((d - t) % n)], wire) for d in range(n)]
        for d in range(n):
            i = (d - t - 1) % n
            accs[d][sl(i)] = accs[d][sl(i)] + sent[(d - 1) % n].to(
                torch.float32)
    if wire != torch.float32:
        for d in range(n):
            own = sl((d + 1) % n)
            accs[d][own] = requant(accs[d][own], wire).to(torch.float32)
    for t in range(n - 1):
        sent = [requant(accs[d][sl((d + 1 - t) % n)], wire)
                for d in range(n)]
        for d in range(n):
            accs[d][sl((d - t) % n)] = sent[(d - 1) % n].to(torch.float32)
    return [acc[:size].to(x0.dtype) for acc in accs]


def _exchange(send: torch.Tensor, recv: torch.Tensor, lg) -> None:
    """One ring step over a level group: send to the next rank, receive
    from the previous one."""
    import torch.distributed as dist
    n, i = lg.size, lg.index
    work = dist.isend(send.contiguous(), lg.ranks[(i + 1) % n],
                      group=lg.group)
    dist.recv(recv, lg.ranks[(i - 1) % n], group=lg.group)
    work.wait()


def ring_reduce_scatter(x: torch.Tensor, lg, seg: int,
                        wire: torch.dtype) -> Tuple[torch.Tensor, int]:
    """The reduce-scatter half over a level group (``collectives.
    LevelGroup``): returns the f32 accumulator and the index of the
    segment this rank now owns, (index + 1) % N, rounded through the
    wire dtype."""
    n, d = lg.size, lg.index
    acc = _seeded(x, n, seg)
    recv = torch.empty((seg,), dtype=wire, device=x.device)
    for t in range(n - 1):
        s, r = (d - t) % n, (d - t - 1) % n
        _exchange(requant(acc[s * seg:(s + 1) * seg], wire), recv, lg)
        acc[r * seg:(r + 1) * seg] = acc[r * seg:(r + 1) * seg] + recv.to(
            torch.float32)
    own = (d + 1) % n
    if wire != torch.float32:
        acc[own * seg:(own + 1) * seg] = requant(
            acc[own * seg:(own + 1) * seg], wire).to(torch.float32)
    return acc, own


def ring_allreduce(x: torch.Tensor, lg,
                   wire_dtype: Optional[torch.dtype] = None,
                   seg_elems: Optional[int] = None) -> torch.Tensor:
    """The ring schedule over a level group with point-to-point sends:
    this rank's result of ``ring_allreduce_ranks``."""
    n, d = lg.size, lg.index
    if n == 1:
        return x
    wire = wire_dtype or x.dtype
    size = x.shape[0]
    seg = seg_elems if seg_elems is not None else ring_seg_elems(size, n)
    acc, _ = ring_reduce_scatter(x, lg, seg, wire)
    recv = torch.empty((seg,), dtype=wire, device=x.device)
    for t in range(n - 1):
        s, r = (d + 1 - t) % n, (d - t) % n
        _exchange(requant(acc[s * seg:(s + 1) * seg], wire), recv, lg)
        acc[r * seg:(r + 1) * seg] = recv.to(torch.float32)
    return acc[:size].to(x.dtype)

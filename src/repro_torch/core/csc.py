"""Coarse-grained sparse communication (paper §3.2, Figs 17–18,
Algorithm 1), in PyTorch.

The gradient pool is cut into fixed-size chunks (paper: 32K gradients).
Each iteration only the top-(1−ρ) fraction of chunks by globally agreed L1
norm is exchanged, packed into a dense buffer so the all-reduce runs at
full bandwidth.

* **Cross-iteration selection** (Fig 18): the per-chunk L1 norms of the
  post-reduce pool are summed over the data-parallel group at the end of
  iteration t; iteration t+1 transmits the top-k chunks by those norms, so
  every rank selects the same chunks.
* **Momentum correction** (Algorithm 1): unselected gradients accumulate
  into the historical buffer ``hg``, scaled by the SGD momentum, and are
  re-injected before the next reduction. The update skips them
  (``optim.sgd``'s mask).
* **Warm-up**: ``core.schedule`` — k is static per stage.
* **Under a model axis** (``parallel.model_axis``) each rank's pool is
  its local pool: its blocks of the sharded leaves and a whole copy of
  every replicated leaf. The selection reads the model group's sum of
  the ranks' chunk norms (``selection_basis``: one f32[chunks]
  all-reduce a sparse step), so every rank of a model group picks the
  same chunk ids, and the same ids are the same elements because every
  local pool has the same segment table. The JAX package selects on each
  rank's own norms, which leaves the replicated copies unequal after a
  sparse step (ROADMAP.md C.1); the port departs from it there. The
  state's ``chunk_norms`` stay the rank's own: the low-bit scales and
  the guard's per-chunk limit read them.

``csc_reduce`` is the monolithic twin of the overlap engine's staged CSC
path (``core.engine``): ``GradientFlow.reduce`` runs it for
``overlap='monolithic'``. On the low-bit wires (``core.wire``) only the
selected chunks are quantized, with scales from the previous iteration's
summed norms (no extra collective), and their error feeds the residual.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import GradientFlowConfig
from repro_torch.core import lazy_allreduce as lazy_mod
from repro_torch.core import wire as wire_mod
from repro_torch.kernels import ref
from repro_torch.parallel.collectives import reduce_pool
from repro_torch.runtime import trace


class CSCState(NamedTuple):
    """hg: f32[pool], this rank's unsent (historical) gradients;
    chunk_norms: f32[chunks], the previous iteration's summed L1 norms,
    the same on every rank."""

    hg: torch.Tensor
    chunk_norms: torch.Tensor


def init_state(pool_size: int, chunk_elems: int, device=None) -> CSCState:
    num_chunks = pool_size // chunk_elems
    assert num_chunks * chunk_elems == pool_size, (
        "pool must be padded to a chunk multiple")
    # Descending norms: a dense warm-up selects every chunk, and the first
    # sparse iteration uses norms of real gradients.
    return CSCState(
        hg=torch.zeros((pool_size,), dtype=torch.float32, device=device),
        chunk_norms=torch.arange(num_chunks, 0, -1, dtype=torch.float32,
                                 device=device))


def select_chunks(chunk_norms: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k chunk ids, sorted ascending, and the bool[chunks] mask.

    Among equal norms the lower chunk id wins, as in ``jax.lax.top_k``: a
    stable descending sort, then its first k (``torch.topk`` orders ties
    otherwise, and zero-norm chunks make ties real). No host sync."""
    with trace.span("gf.select"):
        order = torch.sort(chunk_norms, descending=True, stable=True).indices
        idx = torch.sort(order[:k]).values
        mask = torch.zeros(chunk_norms.shape, dtype=torch.bool,
                           device=chunk_norms.device).index_fill_(0, idx,
                                                                  True)
    return idx, mask


def selection_basis(chunk_norms: torch.Tensor, model_axis=None
                    ) -> torch.Tensor:
    """The norms a sparse step selects on: ``chunk_norms`` itself, or,
    under a model axis of more than one rank, a new tensor holding their
    sum over the model group (``ModelAxis.all_reduce_``, counted in
    ``runtime.trace``'s ``model_axis`` group)."""
    if model_axis is None or model_axis.size == 1:
        return chunk_norms
    return model_axis.all_reduce_(chunk_norms.clone())


def element_mask(chunk_mask: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """bool[chunks] -> bool[pool], each chunk's flag repeated over it."""
    return chunk_mask[:, None].expand(-1, chunk_elems).reshape(-1)


def compact_chunks(pool: torch.Tensor, idx: torch.Tensor,
                   chunk_elems: int) -> torch.Tensor:
    """Gather the selected chunks into the dense wire buffer (k*chunk,)."""
    return ref.csc_compact(pool, idx, chunk_elems)


def scatter_chunks(pool: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """A copy of ``pool`` with the chunks ``idx`` replaced by ``values``."""
    out = pool.clone()
    out.view(-1, chunk_elems).index_copy_(0, idx,
                                          values.view(-1, chunk_elems))
    return out


def chunk_l1_norms(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Per-chunk L1 norm, accumulated in f32 whatever the pool's dtype."""
    return ref.chunk_l1norm(pool, chunk_elems)


def census(pool: torch.Tensor, chunk_elems: int,
           use_kernels: bool) -> torch.Tensor:
    """Per-chunk f32 L1 norms; ``use_kernels`` goes through
    ``kernels.ops.chunk_l1norm``."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.chunk_l1norm(pool, chunk_elems)
    return chunk_l1_norms(pool, chunk_elems)


def summed_census(pool: torch.Tensor, chunk_elems: int,
                  use_kernels: bool, sent=None) -> torch.Tensor:
    """The per-chunk L1 norms of this rank's post-reduce pool, summed over
    the data-parallel group (Fig 18): the next iteration's selection
    basis, the same on every rank. ``sent`` = (idx, l1, ...): the
    low-bit wires' pre-quantization census of the selected chunks, which
    replaces theirs before the sum (see ``csc_reduce``)."""
    with trace.span("gf.census"):
        l1 = census(pool, chunk_elems, use_kernels)
        if sent is not None:
            l1[sent[0]] = sent[1]
        return reduce_pool(l1)


class CSCReduceResult(NamedTuple):
    grads: torch.Tensor      # mean at the selected chunks, zero elsewhere
    elem_mask: torch.Tensor  # bool[pool]: where the update applies
    state: CSCState          # hg differs per rank by design
    residual: Optional[torch.Tensor] = None  # low-bit wires' feedback


def quantize_selection(wire: torch.Tensor, chunk_norms: torch.Tensor,
                       idx: torch.Tensor, chunk_elems: int, spec,
                       num_data_shards: int, use_kernels: bool):
    """The low-bit wires' front half on the compacted buffer ``wire``:
    scales from the previous summed norms at the selected chunks, the
    pre-quantization send census (taken before the clip and the cast can
    eat a NaN or cap a magnitude), the quantize. Returns (q, err, scales,
    send census)."""
    scales = wire_mod.scales_from_census(
        chunk_norms[idx], chunk_elems=chunk_elems,
        num_shards=num_data_shards, spec=spec)
    send_l1 = census(wire, chunk_elems, use_kernels)
    q, err = wire_mod.quantize_pool(wire, scales, chunk_elems=chunk_elems,
                                    spec=spec, num_shards=num_data_shards)
    return q, err, scales, send_l1


def csc_reduce(pool_grads: torch.Tensor, state: CSCState,
               cfg: GradientFlowConfig, *, num_selected: int,
               bucket_boundaries: Sequence[Tuple[int, int]],
               num_data_shards: int, algo=None,
               residual: Optional[torch.Tensor] = None,
               model_axis=None) -> CSCReduceResult:
    """One CSC reduction (Fig 17 + Algorithm 1's preprocess step):
    re-inject hg, select from the previous norms, all-reduce the
    compacted selection in θ buckets over the wire buffer, then the new
    hg and the summed census of the post-reduce pool. ``model_axis``:
    select on the model group's sum of the norms (``selection_basis``).

    On a low-bit wire (``cfg.wire_format``) the selected chunks carry
    ``residual`` too (error feedback; None: none), are quantized with
    scales from ``state.chunk_norms`` at the selected chunks, reduced in
    the scaled domain and dequantized; the new residual (a new tensor)
    takes this step's error at the selected chunks and keeps the rest.
    The selected chunks' census is their pre-quantization send census:
    it carries a NaN or a saturating jump the int8 clip would hide (the
    guard's health channel), it bounds each rank's magnitude as the next
    scales need, and it ranks the chunks as the post-reduce census
    would."""
    chunk = cfg.chunk_elems
    spec = wire_mod.resolve(cfg.wire_format)
    g = pool_grads.to(torch.float32) + state.hg
    idx, chunk_mask = select_chunks(
        selection_basis(state.chunk_norms, model_axis), num_selected)
    elem_mask = element_mask(chunk_mask, chunk)
    g_send = g if (spec is None or residual is None) else g + residual
    if cfg.use_kernels:
        from repro_torch.kernels import ops
        wire = ops.csc_compact(g_send, idx, chunk)
    else:
        wire = compact_chunks(g_send, idx, chunk)
    del g_send
    residual_new, sent = residual, None
    if spec is None:
        parts = lazy_mod.bucketed_reduce_parts(
            wire, bucket_boundaries, getattr(torch, cfg.wire_dtype),
            algo=algo, topo=cfg.topology)
        reduced = torch.cat(parts)
    else:
        q, err, scales, send_l1 = quantize_selection(
            wire, state.chunk_norms, idx, chunk, spec, num_data_shards,
            cfg.use_kernels)
        parts = lazy_mod.bucketed_reduce_parts(q, bucket_boundaries, None,
                                               algo=algo, topo=cfg.topology)
        reduced = wire_mod.dequantize_pool(torch.cat(parts), scales, chunk)
        if residual is not None:
            residual_new = scatter_chunks(residual, idx, err, chunk)
        sent = (idx, send_l1)
    reduced = reduced / num_data_shards
    # Post-reduce view: the mean at the selected chunks, the local g
    # elsewhere (it feeds this rank's hg and census).
    g_out = scatter_chunks(g, idx, reduced, chunk)
    # Update-ready view: the mean at the selected chunks, zero elsewhere.
    g_update = scatter_chunks(torch.zeros_like(g), idx, reduced, chunk)
    hg_new = torch.where(elem_mask, 0.0, cfg.momentum * g_out)
    norms_new = summed_census(g_out, chunk, cfg.use_kernels, sent)
    return CSCReduceResult(grads=g_update, elem_mask=elem_mask,
                           state=CSCState(hg=hg_new, chunk_norms=norms_new),
                           residual=residual_new)


def wire_bucket_boundaries(num_selected: int, chunk_elems: int,
                           bucket_elems: int) -> Tuple[Tuple[int, int], ...]:
    """θ buckets over the packed (k * chunk_elems) wire buffer, aligned to
    chunk boundaries."""
    total = num_selected * chunk_elems
    if bucket_elems <= 0 or bucket_elems >= total:
        return ((0, total),)
    chunks_per_bucket = max(bucket_elems // chunk_elems, 1)
    step = chunks_per_bucket * chunk_elems
    bounds = []
    start = 0
    while start < total:
        end = min(start + step, total)
        bounds.append((start, end))
        start = end
    return tuple(bounds)

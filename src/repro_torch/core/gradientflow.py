"""GradientFlow — the paper's communication backend.

Modes (``GradientFlowConfig.mode``):
  'dense' — one all-reduce per tensor (§2.3 baseline)
  'lazy'  — θ-bucketed all-reduces over the contiguous pool (§3.1)
  'csc'   — lazy + coarse-grained sparse communication (§3.2)
CSC and the low-bit wire formats need the pool padded to a chunk multiple
(``GradientPool(..., pad_to=chunk_elems)``). All modes move gradients in
the wire dtype, or with ``wire_format`` 'int8' / 'fp8_e4m3' as 1-byte
words with per-chunk scales and error feedback (``core.wire``), and hand
the update an f32 mean. Each bucket's collective comes from the topology
layer (``parallel.topology``: flat, two_level, tree, pallas_ring or
auto), and ``auto_bucket`` with a topology tunes θ on the cost model.
``plan`` compiles the layout for the staged overlap engine
(``core.engine``); ``reduce`` runs it monolithically, every bucket before
the update (``overlap='monolithic'``). ``replan`` re-resolves the layout
for a new topology (an elastic event over the same ranks).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import GradientFlowConfig
from repro_torch.core import csc as csc_mod
from repro_torch.core import lazy_allreduce as lazy_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core import wire as wire_mod
from repro_torch.core.pool import GradientPool
from repro_torch.parallel import cost_model
from repro_torch.parallel import topology as topo_mod
from repro_torch.parallel.collectives import reduce_pool

_NOT_PORTED = "is not ported to repro_torch yet; see ROADMAP.md queue A"


class GFState(NamedTuple):
    """GradientFlow's cross-iteration state. CSC carries this rank's
    historical gradients ``hg`` (f32[pool]) and the summed chunk norms
    (f32[chunks]); a low-bit wire with error feedback carries this rank's
    ``residual`` (f32[pool], stored unscaled: the guard's loss scale is
    multiplied in on read and divided out on write). Every other field is
    an empty tensor (the JAX package's placeholders)."""

    hg: torch.Tensor
    chunk_norms: torch.Tensor
    residual: torch.Tensor


def wire_dtype_of(cfg: GradientFlowConfig) -> torch.dtype:
    return getattr(torch, cfg.wire_dtype)


class GradientFlow:
    def __init__(self, cfg: GradientFlowConfig, pool: GradientPool,
                 num_data_shards: int):
        if cfg.mode not in ("dense", "lazy", "csc"):
            raise NotImplementedError(f"GradientFlow mode {cfg.mode!r} "
                                      + _NOT_PORTED)
        self.cfg = cfg
        self.pool = pool
        self.num_data_shards = int(num_data_shards)
        # Validates wire_format when built (an unknown format raises).
        self.wire_spec = wire_mod.resolve(cfg.wire_format)
        if cfg.csc_enabled or self.wire_spec is not None:
            assert pool.size % cfg.chunk_elems == 0, (
                "GradientPool must be constructed with pad_to=chunk_elems "
                "(CSC chunking and per-chunk quantization scales both key "
                "off whole chunks)")
            self.num_chunks = pool.size // cfg.chunk_elems
        else:
            self.num_chunks = 0
        self.stages = schedule_mod.build_stages(cfg, max(self.num_chunks, 1))
        self._stage_firsts = schedule_mod.stage_first_steps(self.stages)
        self._resolve_layout()

    def _resolve_layout(self) -> None:
        """Resolve the topology-dependent layout: bucket boundaries (θ
        re-tuned when auto_bucket), per-bucket algorithms, and the plan
        cache. Called when built and again by ``replan``: everything that
        depends on the topology is derived here, nowhere else."""
        cfg, pool = self.cfg, self.pool
        self._dense_bounds = tuple(
            (s.offset, s.offset + s.size) for s in pool.specs)
        if self._dense_bounds and pool.size > self._dense_bounds[-1][1]:
            self._dense_bounds += ((self._dense_bounds[-1][1], pool.size),)
        self.bucket_elems = cfg.bucket_elems
        if cfg.auto_bucket and cfg.topology is not None:
            # Staged execution prices θ against the overlap engine's full
            # pipeline (the updates overlap the collectives in flight);
            # monolithic keeps the communication-only objective.
            update_bw = cost_model.HBM_BW if cfg.overlap == "staged" \
                else None
            self.bucket_elems, bounds = topo_mod.auto_bucket_boundaries(
                pool, cfg.wire_dtype, cfg.topology,
                collective_algo=cfg.collective_algo, update_bw=update_bw)
            self._lazy_bounds = tuple(bounds)
        else:
            self._lazy_bounds = tuple(
                pool.bucket_boundaries(self.bucket_elems))
        self._dense_algos = self._algos_for(self._dense_bounds)
        self._lazy_algos = self._algos_for(self._lazy_bounds)
        self._plan_cache: dict = {}

    def _algos_for(self, bounds) -> tuple:
        """One algorithm per bucket, selected by the bucket's bytes on the
        wire (1 a word on the low-bit wires)."""
        elt = wire_mod.wire_itemsize(self.cfg.wire_format,
                                     self.cfg.wire_dtype)
        return tuple(topo_mod.resolve_algorithm(self.cfg.collective_algo,
                                                self.cfg.topology,
                                                (e - s) * elt)
                     for s, e in bounds)

    def plan_cache_key(self) -> Tuple:
        topo = self.cfg.topology
        topo_key = tuple((lv.axis, lv.size) for lv in topo.levels) \
            if topo is not None else None
        return (self.cfg.mode, self.cfg.collective_algo,
                str(self.cfg.wire_dtype), self.cfg.wire_format,
                self.num_data_shards, self.bucket_elems, topo_key)

    def replan(self, topology: Optional[topo_mod.Topology] = None, *,
               num_data_shards: Optional[int] = None,
               reduce_axes: Optional[Tuple[str, ...]] = None
               ) -> "GradientFlow":
        """Re-resolve the collective layout for a new topology (an elastic
        event).

        Swaps the (frozen) config's topology / reduce_axes, updates the
        data degree, and re-resolves everything layout-derived: θ is
        re-tuned, per-bucket algorithms re-selected, and the StepPlan
        cache invalidated — the next ``plan()`` compiles for the new
        topology. ``reduce_axes`` defaults to the new topology's axes.
        Returns self for chaining."""
        cfg = self.cfg
        if topology is not None:
            if reduce_axes is None:
                reduce_axes = topology.axes
            cfg = dataclasses.replace(cfg, topology=topology,
                                      reduce_axes=tuple(reduce_axes))
        elif reduce_axes is not None:
            cfg = dataclasses.replace(cfg, reduce_axes=tuple(reduce_axes))
        self.cfg = cfg
        if num_data_shards is not None:
            self.num_data_shards = int(num_data_shards)
        self._resolve_layout()
        return self

    def init_state(self, device=None) -> GFState:
        empty = torch.zeros((0,), dtype=torch.float32, device=device)
        # Pool-shaped when error feedback is live, empty otherwise.
        residual = torch.zeros(
            (self.pool.size if self.cfg.feedback_enabled else 0,),
            dtype=torch.float32, device=device)
        if self.cfg.csc_enabled:
            st = csc_mod.init_state(self.pool.size, self.cfg.chunk_elems,
                                    device)
            return GFState(hg=st.hg, chunk_norms=st.chunk_norms,
                           residual=residual)
        return GFState(hg=empty, chunk_norms=empty, residual=residual)

    def stage_for_step(self, step: int) -> schedule_mod.SparsityStage:
        return schedule_mod.stage_at(self.stages, step,
                                     first_steps=self._stage_firsts)

    def plan(self, stage=None):
        """The bucket layout compiled into the overlap engine's
        ``StepPlan``, cached per (layout key, stage). CSC's default stage
        is the last (steady) one."""
        key = (self.plan_cache_key(), stage)
        plan = self._plan_cache.get(key)
        if plan is None:
            from repro_torch.core import engine
            plan = engine.compile_step_plan(self, stage)
            self._plan_cache[key] = plan
        return plan

    # -- the monolithic reduction ---------------------------------------------

    def reduce(self, pool_grads: torch.Tensor, state: GFState, *,
               stage=None, prepacked: bool = False,
               census: Optional[torch.Tensor] = None,
               census_sum: Optional[torch.Tensor] = None, loss_scale=None
               ) -> Tuple[torch.Tensor, torch.Tensor, GFState]:
        """Reduce the local gradient pool across the data-parallel group,
        every bucket before any update (``overlap='monolithic'``).

        Returns (mean f32[pool], element mask bool[pool], new state). The
        mask is all true except at CSC's unselected chunks, where the mean
        is zero and the update must not apply (Algorithm 1). With
        ``prepacked`` the dense and lazy buckets are already in the wire
        dtype and go on the wire without a cast (and are summed in place);
        CSC and the low-bit wires take the f32 pool, because hg and the
        residual are added before the wire cast.

        Low-bit wires, dense and lazy: the f32 ``pool_grads`` is
        overwritten with ``pool_grads + residual``. ``census`` is this
        rank's chunk-L1 census of ``pool_grads`` from the pack (taken here
        when None); it is summed over the group (one f32[chunks]
        collective) and the per-chunk scales come from the sum.
        ``census_sum`` hands in a census already summed instead (the
        guarded monolithic step, whose verdict reads it too: the guarded
        step then issues the unguarded step's collectives).
        ``loss_scale`` is the guard's power-of-two scale on ``pool_grads``
        (None: 1): the residual is stored unscaled, so it is multiplied by
        the scale on read and the new one divided by it on write. The new
        residual is a new tensor; the state passed in is not written. On
        the native wires the three keywords change nothing, as in JAX.
        """
        cfg = self.cfg
        if cfg.mode == "csc":
            assert not prepacked, (
                "CSC consumes the f32 pool: pack with dtype=float32")
            stage = stage or self.stages[-1]
            k = stage.num_selected
            if k >= self.num_chunks:
                # The dense warm-up keeps native transport on the low-bit
                # wires too: no census basis yet for their scales.
                return self._dense_or_lazy_with_norms(pool_grads, state)
            bounds = csc_mod.wire_bucket_boundaries(k, cfg.chunk_elems,
                                                    self.bucket_elems)
            feedback = cfg.feedback_enabled
            res = csc_mod.csc_reduce(
                pool_grads, csc_mod.CSCState(hg=state.hg,
                                             chunk_norms=state.chunk_norms),
                cfg, num_selected=k, bucket_boundaries=bounds,
                num_data_shards=self.num_data_shards,
                algo=self._algos_for(bounds),
                residual=state.residual if feedback else None)
            return res.grads, res.elem_mask, GFState(
                hg=res.state.hg, chunk_norms=res.state.chunk_norms,
                residual=res.residual if feedback else state.residual)
        dense = cfg.mode == "dense"
        bounds = self._dense_bounds if dense else self._lazy_bounds
        algos = self._dense_algos if dense else self._lazy_algos
        if self.wire_spec is not None:
            assert not prepacked, (
                "the low-bit wires consume the f32 pool: pack with "
                "dtype=float32")
            return self._quantized_dense_or_lazy(
                pool_grads, state, bounds, algos, census=census,
                census_sum=census_sum, loss_scale=loss_scale)
        summed = lazy_mod.bucketed_reduce(
            pool_grads, bounds, None if prepacked else wire_dtype_of(cfg),
            algo=algos, topo=cfg.topology)
        mean = summed / self.num_data_shards
        return mean, torch.ones(mean.shape, dtype=torch.bool,
                                device=mean.device), state

    def quantized_scales(self, census_sum: torch.Tensor) -> torch.Tensor:
        """Per-chunk wire scales from a census summed over the group."""
        return wire_mod.scales_from_census(
            census_sum, chunk_elems=self.cfg.chunk_elems,
            num_shards=self.num_data_shards, spec=self.wire_spec)

    def quantize(self, pool_grads: torch.Tensor, state: GFState, *,
                 census=None, census_sum=None, loss_scale=None, out=None):
        """The low-bit dense/lazy front half, which ``reduce`` and the
        staged engine share: the census summed over the group (unless
        ``census_sum`` is given; ``census`` is the pack's, taken from
        ``pool_grads`` when None), ``pool_grads + residual`` in place (the
        residual times ``loss_scale`` when given: it is stored unscaled),
        then one quantize pass whose error lands in ``out`` (a new buffer
        when None; it must not be the live residual when a guard may keep
        it). Returns (words, error, scales, census sum)."""
        cfg = self.cfg
        chunk = cfg.chunk_elems
        if census_sum is None:
            if census is None:
                census = wire_mod.chunk_l1(pool_grads, chunk)
            census_sum = reduce_pool(census)
        if cfg.feedback_enabled:
            r = state.residual
            if loss_scale is not None:
                r = torch.mul(r, loss_scale, out=out)
            pool_grads.add_(r)
        scales = self.quantized_scales(census_sum)
        q, err = wire_mod.quantize_pool(
            pool_grads, scales, chunk_elems=chunk, spec=self.wire_spec,
            num_shards=self.num_data_shards, out=out)
        return q, err, scales, census_sum

    def _quantized_dense_or_lazy(self, pool_grads: torch.Tensor,
                                 state: GFState, bounds, algos, *,
                                 census=None, census_sum=None,
                                 loss_scale=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            GFState]:
        """Dense/lazy transport on a low-bit wire: ``quantize``, the
        1-byte buckets on the wire, the dequantized mean after."""
        cfg = self.cfg
        q, err, scales, _ = self.quantize(
            pool_grads, state, census=census, census_sum=census_sum,
            loss_scale=loss_scale)
        summed = lazy_mod.bucketed_reduce(q, bounds, None, algo=algos,
                                          topo=cfg.topology)
        mean = summed.view(-1, cfg.chunk_elems).mul_(scales[:, None])
        mean = mean.view(-1).div_(self.num_data_shards)
        if cfg.feedback_enabled:
            residual = err if loss_scale is None else err.div_(loss_scale)
            state = state._replace(residual=residual)
        return mean, torch.ones(mean.shape, dtype=torch.bool,
                                device=mean.device), state

    def _dense_or_lazy_with_norms(self, pool_grads: torch.Tensor,
                                  state: GFState
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             GFState]:
        """CSC's dense warm-up: the hg-corrected pool reduced in lazy
        buckets, then the summed census of the mean, which keeps the norms
        tracking for the sparse handoff; hg is zeroed."""
        cfg = self.cfg
        g = pool_grads.to(torch.float32) + state.hg
        summed = lazy_mod.bucketed_reduce(g, self._lazy_bounds,
                                          wire_dtype_of(cfg),
                                          algo=self._lazy_algos,
                                          topo=cfg.topology)
        mean = summed / self.num_data_shards
        mask = torch.ones(mean.shape, dtype=torch.bool, device=mean.device)
        return mean, mask, state._replace(
            hg=torch.zeros_like(state.hg),
            chunk_norms=csc_mod.summed_census(mean, cfg.chunk_elems,
                                              cfg.use_kernels))

    # -- analytics ------------------------------------------------------------

    def wire_bytes_per_step(self, stage=None) -> int:
        """Bytes entering the all-reduce on each device (model, not
        measured). The low-bit wires count 1 byte a payload element plus
        the f32 census: CSC's norm all-reduce carries it already, dense
        and lazy add their census sum. A native sparse CSC stage counts
        its norm census at the wire width, as the JAX package does; CSC's
        warm-up stays on the native wire."""
        elt = wire_mod.wire_itemsize(self.cfg.wire_format,
                                     self.cfg.wire_dtype)
        quantized = self.wire_spec is not None
        census_bytes = self.num_chunks * 4
        if self.cfg.mode == "csc":
            stage = stage or self.stages[-1]
            if stage.num_selected < self.num_chunks:
                payload = stage.num_selected * self.cfg.chunk_elems * elt
                return payload + (census_bytes if quantized
                                  else self.num_chunks * elt)
            native = torch.empty((), dtype=wire_dtype_of(self.cfg)
                                 ).element_size()
            return self.pool.size * native + census_bytes
        payload = self.pool.size * elt
        return payload + census_bytes if quantized else payload

    def num_collectives(self, stage=None) -> int:
        """Collectives a step issues; CSC adds the norm census, the
        low-bit dense and lazy wires their census sum."""
        cfg = self.cfg
        extra = 1 if (self.wire_spec is not None
                      and cfg.mode in ("dense", "lazy")) else 0
        if cfg.mode == "dense":
            return len(self._dense_bounds) + extra
        if cfg.mode == "lazy":
            return len(self._lazy_bounds) + extra
        stage = stage or self.stages[-1]
        if stage.num_selected >= self.num_chunks:
            return len(self._lazy_bounds) + 1
        return len(csc_mod.wire_bucket_boundaries(
            stage.num_selected, cfg.chunk_elems, self.bucket_elems)) + 1

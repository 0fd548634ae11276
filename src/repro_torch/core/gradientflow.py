"""GradientFlow — the paper's communication backend.

Modes (``GradientFlowConfig.mode``):
  'dense' — one all-reduce per tensor (§2.3 baseline)
  'lazy'  — θ-bucketed all-reduces over the contiguous pool (§3.1)
  'csc'   — lazy + coarse-grained sparse communication (§3.2): the pool
            must be padded to a chunk multiple
              (``GradientPool(..., pad_to=chunk_elems)``)
All modes move gradients in the wire dtype and hand the update an f32
mean. Each bucket's collective comes from the topology layer
(``parallel.topology``: flat, two_level, tree, pallas_ring or auto), and
``auto_bucket`` with a topology tunes θ on the cost model. ``plan``
compiles the layout for the staged overlap engine (``core.engine``);
``reduce`` runs it monolithically, every bucket before the update
(``overlap='monolithic'``). The low-bit wire formats (which give
``reduce``'s ``census_sum`` and ``loss_scale`` their use) and ``replan``
are not ported yet (see ROADMAP.md A.13, A.15).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import GradientFlowConfig
from repro_torch.core import csc as csc_mod
from repro_torch.core import lazy_allreduce as lazy_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.pool import GradientPool
from repro_torch.parallel import cost_model
from repro_torch.parallel import topology as topo_mod

_NOT_PORTED = "is not ported to repro_torch yet; see ROADMAP.md queue A"


class GFState(NamedTuple):
    """GradientFlow's cross-iteration state. CSC carries this rank's
    historical gradients ``hg`` (f32[pool]) and the summed chunk norms
    (f32[chunks]); every other field, and every field in dense and lazy
    modes, is an empty tensor (the JAX package's placeholders)."""

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
        if cfg.quantized:
            raise NotImplementedError(
                f"wire_format {cfg.wire_format!r} is not ported to "
                f"repro_torch yet; see ROADMAP.md A.13")
        self.cfg = cfg
        self.pool = pool
        self.num_data_shards = int(num_data_shards)
        if cfg.csc_enabled:
            assert pool.size % cfg.chunk_elems == 0, (
                "GradientPool must be constructed with pad_to=chunk_elems "
                "(CSC chunking keys off whole chunks)")
            self.num_chunks = pool.size // cfg.chunk_elems
        else:
            self.num_chunks = 0
        self.stages = schedule_mod.build_stages(cfg, max(self.num_chunks, 1))
        self._stage_firsts = schedule_mod.stage_first_steps(self.stages)
        self._resolve_layout()

    def _resolve_layout(self) -> None:
        """Bucket boundaries and per-bucket algorithms for both modes."""
        cfg, pool = self.cfg, self.pool
        self._dense_bounds = tuple(
            (s.offset, s.offset + s.size) for s in pool.specs)
        if self._dense_bounds and pool.size > self._dense_bounds[-1][1]:
            self._dense_bounds += ((self._dense_bounds[-1][1], pool.size),)
        self.bucket_elems = cfg.bucket_elems
        if cfg.auto_bucket and cfg.topology is not None:
            # The staged pipeline (the port's only overlap) prices θ
            # against the per-bucket updates too.
            self.bucket_elems, bounds = topo_mod.auto_bucket_boundaries(
                pool, cfg.wire_dtype, cfg.topology,
                collective_algo=cfg.collective_algo,
                update_bw=cost_model.HBM_BW)
            self._lazy_bounds = tuple(bounds)
        else:
            self._lazy_bounds = tuple(
                pool.bucket_boundaries(self.bucket_elems))
        self._dense_algos = self._algos_for(self._dense_bounds)
        self._lazy_algos = self._algos_for(self._lazy_bounds)
        self._plan_cache: dict = {}

    def _algos_for(self, bounds) -> tuple:
        elt = torch.empty((), dtype=wire_dtype_of(self.cfg)).element_size()
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

    def init_state(self, device=None) -> GFState:
        empty = torch.zeros((0,), dtype=torch.float32, device=device)
        if self.cfg.csc_enabled:
            st = csc_mod.init_state(self.pool.size, self.cfg.chunk_elems,
                                    device)
            return GFState(hg=st.hg, chunk_norms=st.chunk_norms,
                           residual=empty)
        return GFState(hg=empty, chunk_norms=empty, residual=empty)

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
               stage=None, prepacked: bool = False, census_sum=None,
               loss_scale=None
               ) -> Tuple[torch.Tensor, torch.Tensor, GFState]:
        """Reduce the local gradient pool across the data-parallel group,
        every bucket before any update (``overlap='monolithic'``).

        Returns (mean f32[pool], element mask bool[pool], new state). The
        mask is all true except at CSC's unselected chunks, where the mean
        is zero and the update must not apply (Algorithm 1). With
        ``prepacked`` the dense and lazy buckets are already in the wire
        dtype and go on the wire without a cast (and are summed in place);
        CSC takes the f32 pool, because hg is added before the selection.

        ``census_sum`` (an already summed chunk census) and ``loss_scale``
        (the guard's scale on ``pool_grads``) are the JAX package's
        keywords for the quantized wires, where the census sets the wire
        scales and the scale keeps the error feedback unscaled. On the
        native wires they change nothing, as in JAX.
        """
        del census_sum, loss_scale  # inert on native wires
        cfg = self.cfg
        if cfg.mode == "csc":
            assert not prepacked, (
                "CSC consumes the f32 pool: pack with dtype=float32")
            stage = stage or self.stages[-1]
            k = stage.num_selected
            if k >= self.num_chunks:
                return self._dense_or_lazy_with_norms(pool_grads, state)
            bounds = csc_mod.wire_bucket_boundaries(k, cfg.chunk_elems,
                                                    self.bucket_elems)
            res = csc_mod.csc_reduce(
                pool_grads, csc_mod.CSCState(hg=state.hg,
                                             chunk_norms=state.chunk_norms),
                cfg, num_selected=k, bucket_boundaries=bounds,
                num_data_shards=self.num_data_shards,
                algo=self._algos_for(bounds))
            return res.grads, res.elem_mask, state._replace(
                hg=res.state.hg, chunk_norms=res.state.chunk_norms)
        dense = cfg.mode == "dense"
        summed = lazy_mod.bucketed_reduce(
            pool_grads, self._dense_bounds if dense else self._lazy_bounds,
            None if prepacked else wire_dtype_of(cfg),
            algo=self._dense_algos if dense else self._lazy_algos,
            topo=cfg.topology)
        mean = summed / self.num_data_shards
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
        measured). A sparse CSC stage sends its k chunks plus the norm
        census, counted at the wire width as the JAX package counts it."""
        elt = torch.empty((), dtype=wire_dtype_of(self.cfg)).element_size()
        if self.cfg.mode == "csc":
            stage = stage or self.stages[-1]
            if stage.num_selected < self.num_chunks:
                return (stage.num_selected * self.cfg.chunk_elems * elt
                        + self.num_chunks * elt)
            return self.pool.size * elt + self.num_chunks * 4
        return self.pool.size * elt

    def num_collectives(self, stage=None) -> int:
        """Collectives a step issues; CSC adds the norm census."""
        if self.cfg.mode == "dense":
            return len(self._dense_bounds)
        if self.cfg.mode == "lazy":
            return len(self._lazy_bounds)
        stage = stage or self.stages[-1]
        if stage.num_selected >= self.num_chunks:
            return len(self._lazy_bounds) + 1
        return len(csc_mod.wire_bucket_boundaries(
            stage.num_selected, self.cfg.chunk_elems, self.bucket_elems)) + 1

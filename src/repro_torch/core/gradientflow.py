"""GradientFlow — the paper's communication backend, dense and lazy modes.

Modes (``GradientFlowConfig.mode``):
  'dense' — one all-reduce per tensor (§2.3 baseline)
  'lazy'  — θ-bucketed all-reduces over the contiguous pool (§3.1)
Both move gradients in the wire dtype and hand the update an f32 mean.
CSC, the low-bit wire formats, θ auto-tuning and the other collective
algorithms are not ported yet and raise (see ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import GradientFlowConfig
from repro_torch.core.pool import GradientPool
from repro_torch.parallel import topology as topo_mod

_NOT_PORTED = "is not ported to repro_torch yet; see ROADMAP.md queue A"


class GFState(NamedTuple):
    """GradientFlow's cross-iteration state. Dense and lazy modes carry
    none: every field is an empty tensor (the JAX package's placeholders)."""

    hg: torch.Tensor
    chunk_norms: torch.Tensor
    residual: torch.Tensor


def wire_dtype_of(cfg: GradientFlowConfig) -> torch.dtype:
    return getattr(torch, cfg.wire_dtype)


class GradientFlow:
    def __init__(self, cfg: GradientFlowConfig, pool: GradientPool,
                 num_data_shards: int):
        if cfg.mode not in ("dense", "lazy"):
            raise NotImplementedError(f"GradientFlow mode {cfg.mode!r} "
                                      + _NOT_PORTED)
        if cfg.quantized:
            raise NotImplementedError(f"wire_format {cfg.wire_format!r} "
                                      + _NOT_PORTED)
        if cfg.auto_bucket and cfg.topology is not None:
            raise NotImplementedError("auto_bucket (θ auto-tuning) "
                                      + _NOT_PORTED)
        self.cfg = cfg
        self.pool = pool
        self.num_data_shards = int(num_data_shards)
        self.num_chunks = 0
        self._resolve_layout()

    def _resolve_layout(self) -> None:
        """Bucket boundaries and per-bucket algorithms for both modes."""
        cfg, pool = self.cfg, self.pool
        self._dense_bounds = tuple(
            (s.offset, s.offset + s.size) for s in pool.specs)
        if self._dense_bounds and pool.size > self._dense_bounds[-1][1]:
            self._dense_bounds += ((self._dense_bounds[-1][1], pool.size),)
        self.bucket_elems = cfg.bucket_elems
        self._lazy_bounds = tuple(pool.bucket_boundaries(self.bucket_elems))
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
        return GFState(hg=empty, chunk_norms=empty, residual=empty)

    def plan(self, stage=None):
        """The bucket layout compiled into the overlap engine's
        ``StepPlan``, cached per layout key."""
        key = (self.plan_cache_key(), stage)
        plan = self._plan_cache.get(key)
        if plan is None:
            from repro_torch.core import engine
            plan = engine.compile_step_plan(self, stage)
            self._plan_cache[key] = plan
        return plan

    # -- analytics ------------------------------------------------------------

    def wire_bytes_per_step(self, stage=None) -> int:
        """Bytes entering the all-reduce on each device (model, not
        measured)."""
        elt = torch.empty((), dtype=wire_dtype_of(self.cfg)).element_size()
        return self.pool.size * elt

    def num_collectives(self, stage=None) -> int:
        if self.cfg.mode == "dense":
            return len(self._dense_bounds)
        return len(self._lazy_bounds)

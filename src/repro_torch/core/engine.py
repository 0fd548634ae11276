"""Overlap engine: the per-bucket staged pipeline (paper §3.1's
computation/communication overlap), native dense and lazy paths.

* ``StepPlan`` — one ``BucketTask`` per collective plus the
  tensor-aligned update spans, compiled from GradientFlow's layout.
* ``OverlapEngine.run`` — bucket *i*'s all-reduce is issued
  (asynchronously) before bucket *i-1*'s fused optimizer update is
  launched, and each bucket's handle is waited on just before its own
  update, so the update of one bucket runs while the next one's
  collective is in flight.

The JAX engine fences each update with ``optimization_barrier`` to pin
XLA's fusion decisions; PyTorch runs eagerly, so there is nothing to
fence. CSC, the guard, the quantized wires and the cross-step lane are
not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.core import lazy_allreduce as lazy_mod


@dataclasses.dataclass(frozen=True)
class BucketTask:
    """One collective of the step: pool span [start, end) and its
    algorithm. Its result unblocks the update of the same span."""

    index: int
    start: int
    end: int
    algo: Any

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The compiled pipeline of one train step."""

    mode: str
    pool_size: int
    payload_elems: int
    wire_dtype: str
    num_data_shards: int
    tasks: Tuple[BucketTask, ...]
    update_spans: Tuple[Tuple[int, int], ...]

    @property
    def num_collectives(self) -> int:
        return len(self.tasks)

    def validate(self) -> None:
        """Tasks tile [0, payload_elems) and update spans tile
        [0, pool_size), each exactly once, in order."""
        pos = 0
        for t in self.tasks:
            assert t.start == pos and t.end > t.start, (t, pos)
            pos = t.end
        assert pos == self.payload_elems, (pos, self.payload_elems)
        pos = 0
        for s, e in self.update_spans:
            assert s == pos and e > s, ((s, e), pos)
            pos = e
        assert pos == self.pool_size, (pos, self.pool_size)


def compile_step_plan(gf, stage=None) -> StepPlan:
    """GradientFlow's bucket layout as an explicit StepPlan."""
    cfg = gf.cfg
    pool = gf.pool
    if cfg.pipeline_tail_buckets != 0:
        raise NotImplementedError(
            "pipeline_tail_buckets (the cross-step lane) is not ported to "
            "repro_torch yet; see ROADMAP.md queue A")
    common = dict(pool_size=pool.size, payload_elems=pool.size,
                  wire_dtype=str(cfg.wire_dtype),
                  num_data_shards=gf.num_data_shards)
    if cfg.mode == "dense":
        bounds = list(gf._dense_bounds) or [(0, pool.size)]
        algos = gf._algos_for(tuple(bounds))
    else:
        assert cfg.mode == "lazy", cfg.mode
        bounds, algos = list(gf._lazy_bounds), gf._lazy_algos
    tasks = tuple(BucketTask(index=i, start=s, end=e, algo=a)
                  for i, ((s, e), a) in enumerate(zip(bounds, algos)))
    return StepPlan(mode=cfg.mode, tasks=tasks, update_spans=tuple(bounds),
                    **common)


class OverlapEngine:
    """Executes a StepPlan as a software pipeline of per-bucket
    all-reduces and fused optimizer updates."""

    def __init__(self, gf, opt_name: str, opt_cfg):
        if opt_name != "momentum_sgd":
            raise NotImplementedError(
                f"optimizer {opt_name!r} is not ported to repro_torch yet; "
                "see ROADMAP.md queue A")
        self.gf = gf
        self.pool = gf.pool
        self.opt_name = opt_name
        self.opt_cfg = opt_cfg

    def plan_for(self, stage=None) -> StepPlan:
        return self.gf.plan(stage)

    def run(self, plan: StepPlan, gpool: torch.Tensor, params_tree,
            opt_state, gfstate, lr: torch.Tensor):
        """One pipelined reduce+update phase. ``gpool`` is the local
        gradient pool, already packed in the wire dtype. The parameters
        and the momentum are updated in place (see ``kernels.pool_unpack``).
        Returns (params_tree, opt_state, gfstate)."""
        use_k = self.gf.cfg.use_kernels
        master, _ = self.pool.pack(params_tree, dtype=torch.float32,
                                   use_kernels=use_k)
        leaves = self.pool.flat_leaves(params_tree)
        outs = self._run_pool_pipeline(plan, gpool, master, leaves,
                                       opt_state, lr)
        return self._assemble(outs), opt_state, gfstate

    def _run_pool_pipeline(self, plan, gpool, master, leaves, opt_state,
                           lr) -> List[Any]:
        """Issue reduce_i, then launch update_{i-1} while it is in flight;
        wait on each bucket just before its own update."""
        outs: List[Any] = [None] * len(plan.tasks)
        pending = None
        for task in plan.tasks:
            issued = lazy_mod.issue_bucket(gpool, task.start, task.end, None,
                                           algo=task.algo)
            if pending is not None:
                pt, pb = pending
                outs[pt.index] = self._update_span(
                    (pt.start, pt.end), pb.wait() / plan.num_data_shards,
                    master, leaves, opt_state, lr)
            pending = (task, issued)
        pt, pb = pending
        outs[pt.index] = self._update_span(
            (pt.start, pt.end), pb.wait() / plan.num_data_shards, master, leaves,
            opt_state, lr)
        return outs

    def _update_span(self, span, red_seg, master, leaves, opt_state, lr):
        """One update span's fused optimizer step on the span's segments;
        the new values land in the span's parameter leaves and in the
        momentum buffer's slice. In lazy and dense modes every element is
        updated (an all-true mask). Returns the span's leaves."""
        start, end = span
        view = self.pool.bucket_view(start, end)
        mask = torch.ones((view.size,), dtype=torch.bool,
                          device=master.device)
        return self._update_view_seg(view, master[start:end], red_seg,
                                     opt_state, lr, mask,
                                     leaves[view.leaf_lo:view.leaf_hi])

    def _update_view_seg(self, view, m_seg, red_seg, opt_state, lr, mask,
                         out_leaves):
        from repro_torch import optim
        st_seg = opt_state.__class__(
            momentum=opt_state.momentum[view.start:view.end])
        new_leaves, _ = optim.update_view(
            self.opt_name, view, m_seg, red_seg, st_seg, mask, self.opt_cfg,
            lr, use_kernels=self.gf.cfg.use_kernels, out_leaves=out_leaves)
        return new_leaves

    def _assemble(self, outs):
        """The per-span leaves back into the parameter tree."""
        all_leaves = [leaf for leaves in outs for leaf in leaves]
        assert len(all_leaves) == self.pool.num_tensors, (
            len(all_leaves), self.pool.num_tensors)
        return self.pool.unflatten(all_leaves)

"""Overlap engine: the per-bucket staged pipeline (paper §3.1's
computation/communication overlap), native dense, lazy and CSC paths.

* ``StepPlan`` — one ``BucketTask`` per collective plus the
  tensor-aligned update spans, compiled from GradientFlow's layout.
* ``OverlapEngine.run`` — bucket *i*'s all-reduce is issued
  (asynchronously) before bucket *i-1*'s fused optimizer update is
  launched, and each bucket's handle is waited on just before its own
  update, so the update of one bucket runs while the next one's
  collective is in flight. CSC's sparse stages pipeline the all-reduce of
  wire bucket *i* against the scatter of bucket *i-1* instead, then run
  the masked update per span; its dense warm-up is the lazy pipeline on
  the hg-corrected pool plus the norm census.

Each span's update is the optimizer's segment update (``optim.
update_view``): momentum SGD or LARS through the update kernel, LARS with
the trust ratios of the span's tensors (``optim.lars``, computed on the
device from the span's master and masked gradient), AdamW as PyTorch ops
writing its state in place. ``overlap='monolithic'`` does not come here:
the Trainer runs ``GradientFlow.reduce`` and one whole-pool update.

On the low-bit wires (``core.wire``) dense and lazy quantize the whole
pool once (``g + residual`` in place in the f32 staging pool, scales from
the summed pack census, the new residual written over the old), run the
same pipeline on the 1-byte words and dequantize each bucket's mean as
it retires; CSC quantizes the compacted selection with scales from the
previous norms and dequantizes each wire bucket before its scatter.

``OverlapEngine.run_guarded`` is the numeric guard's twin of ``run``
(``core.guard``): the same collectives in the same order, every bucket's
reduce issued before any update (the verdict needs all of them, so the
guarded stages give up the reduce_i ∥ update_{i-1} overlap), the health
verdict from the reduced buckets' words, CSC's summed census or, on the
low-bit wires, the census sum (the clip hides poison from the words),
and every write of the step behind the device flag ``ok``: the residual
too.

Under a model axis (``GradientFlow.model_axis``) every path runs on the
rank's local pool and reduces over its data group; two things read the
model group: CSC's selection (the group's summed chunk norms,
``csc.selection_basis``) and the guard's verdict (the group's max of the
flags, ``guard.group_verdict``), so the ranks of a model group pick the
same chunks and commit or skip together.

The cross-step pipeline (``pipeline_tail_buckets``): a plan's last
``pipeline_tail`` tasks carry ``commit_epoch=1``. Inside a train window
(``Trainer.build_train_window``) ``run_pipelined`` still reduces them in
step t but parks their means in an ``InflightLane``; ``apply_inflight``
updates their spans at the start of step t+1, before the forward pass
reads those parameters, and once more at the window's edge. ``run``
ignores the tag, so a per-step step with a tail config runs
unpipelined, as in the JAX package. A lane segment is the f32 mean the
in-step update would have read (``lazy_allreduce``'s ``wait() / N``,
divided by the loss scale when guarded), not the JAX package's
wire-dtype carry: the deferred update then reads the same bits as the
unpipelined one, so pipelined and unpipelined training agree bit for
bit. The JAX package's segment-carry forms (``pool_split``,
``run_pipelined_segs``) exist so that XLA copies no pool; the port's
updates are in place already, and they are not ported.

The JAX engine fences each update with ``optimization_barrier`` to pin
XLA's fusion decisions; PyTorch runs eagerly, so there is nothing to
fence.

The stages run in ``runtime.trace`` spans: CSC's ``gf.gather`` and each
bucket's ``gf.scatter`` here, each span's ``gf.update`` and
``gf.apply_inflight``; ``gf.issue`` and ``gf.wait`` in
``lazy_allreduce``, ``gf.select`` and ``gf.census`` in ``csc``,
``gf.pack`` in ``pool``.

The analytic twin (``simulate_plan``, ``render_timeline``,
``simulate_plan_pipelined``, ``render_cross_step_timeline``) prices a
plan on a ``Topology`` with the cost model's two-engine timeline: no
pool, no device. ``launch.dryrun --timeline`` and the elastic soak
(``runtime.soak``) read it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import csc as csc_mod
from repro_torch.core import lazy_allreduce as lazy_mod
from repro_torch.core import wire as wire_mod
from repro_torch.kernels import ref
from repro_torch.parallel import cost_model
from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class BucketTask:
    """One collective of the step: payload span [start, end) of the wire
    buffer (the pool for dense and lazy, the compacted k-chunk buffer for
    CSC) and its algorithm. ``update_span`` is the pool range its result
    unblocks: the payload span for dense and lazy, None for CSC's sparse
    stages (their update spans are the plan's own). ``commit_epoch`` 1
    defers the span's update to the start of the next step (the
    cross-step lane); 0 commits it in the step."""

    index: int
    start: int
    end: int
    algo: Any
    update_span: Optional[Tuple[int, int]] = None
    commit_epoch: int = 0

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The compiled pipeline of one train step. For CSC, ``warmup`` marks
    the dense warm-up stage (pool-space tasks) and ``num_selected`` is the
    stage's k; a sparse stage's tasks tile the k-chunk wire buffer. The
    last ``pipeline_tail`` tasks carry ``commit_epoch=1`` (native dense
    and lazy plans only). ``plan_key`` is the layout key
    (``GradientFlow.plan_cache_key``) the plan was compiled under: a
    ``replan`` that changes the topology, the data degree or θ changes
    it."""

    mode: str
    pool_size: int
    payload_elems: int
    wire_dtype: str
    num_data_shards: int
    tasks: Tuple[BucketTask, ...]
    update_spans: Tuple[Tuple[int, int], ...]
    warmup: bool = False
    num_selected: int = 0
    chunk_elems: int = 0
    pipeline_tail: int = 0
    plan_key: Tuple = ()

    @property
    def num_collectives(self) -> int:
        return len(self.tasks)

    @property
    def head_tasks(self) -> Tuple[BucketTask, ...]:
        return self.tasks[:len(self.tasks) - self.pipeline_tail]

    @property
    def tail_tasks(self) -> Tuple[BucketTask, ...]:
        """The deferred (``commit_epoch=1``) suffix, in plan order."""
        return self.tasks[len(self.tasks) - self.pipeline_tail:]

    def validate(self) -> None:
        """Tasks tile [0, payload_elems) and update spans tile
        [0, pool_size), each exactly once, in order. The deferred tasks
        are exactly the ``pipeline_tail``-long suffix, and only a native
        dense or lazy plan (static update spans equal to the payload
        spans) has one."""
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
        n = len(self.tasks)
        assert 0 <= self.pipeline_tail < max(n, 1), (self.pipeline_tail, n)
        for i, t in enumerate(self.tasks):
            want = 1 if i >= n - self.pipeline_tail else 0
            assert t.commit_epoch == want, (i, t.commit_epoch, want)
        if self.pipeline_tail:
            assert self.mode in ("dense", "lazy") and not self.warmup, self
            for t in self.tail_tasks:
                assert t.update_span == (t.start, t.end), t


def resolve_pipeline_tail(gf, tasks) -> int:
    """How many trailing buckets the cross-step pipeline defers
    (``GradientFlowConfig.pipeline_tail_buckets``): 0 none, N > 0 the
    last min(N, buckets - 1), -1 the depth ``cost_model.
    select_pipeline_tail`` picks on the config's topology (1 without
    one). CSC (dynamic update spans) and the low-bit wires (the lane
    would need the per-chunk scales too) never pipeline."""
    cfg = gf.cfg
    want = cfg.pipeline_tail_buckets
    n = len(tasks)
    if want == 0 or n <= 1 or cfg.mode == "csc" or gf.wire_spec is not None:
        return 0
    if want > 0:
        return min(want, n - 1)
    if want != -1:
        raise ValueError(f"pipeline_tail_buckets must be >= -1, got {want}")
    topo = cfg.topology
    if topo is None:
        return 1
    elt = torch.empty((), dtype=getattr(torch, cfg.wire_dtype)).element_size()
    sizes = [t.size * elt for t in tasks]
    backward_s = cost_model.ring_allreduce_time(
        sum(t.size for t in tasks) * elt, topo.num_devices,
        topo.slowest_fabric)
    comm = [t.algo.predicted_time(b, topo) for t, b in zip(tasks, sizes)]
    rel = cost_model.bucket_release_times(sizes, backward_s)
    upd = [cost_model.update_time(t.size) for t in tasks]
    return cost_model.select_pipeline_tail(comm, rel, upd, backward_s)


def _tag_tail(tasks, tail: int) -> Tuple[BucketTask, ...]:
    """Stamp ``commit_epoch=1`` on the deferred suffix."""
    n = len(tasks)
    return tuple(dataclasses.replace(t, commit_epoch=1) if i >= n - tail
                 else t for i, t in enumerate(tasks))


def compile_step_plan(gf, stage=None) -> StepPlan:
    """GradientFlow's bucket layout as an explicit StepPlan."""
    cfg = gf.cfg
    pool = gf.pool
    common = dict(pool_size=pool.size, wire_dtype=str(cfg.wire_dtype),
                  num_data_shards=gf.num_data_shards,
                  plan_key=gf.plan_cache_key())

    def make_tasks(bounds, algos, spans=True):
        return tuple(BucketTask(index=i, start=s, end=e, algo=a,
                                update_span=(s, e) if spans else None)
                     for i, ((s, e), a) in enumerate(zip(bounds, algos)))

    if cfg.mode in ("dense", "lazy"):
        if cfg.mode == "dense":
            bounds = list(gf._dense_bounds) or [(0, pool.size)]
            algos = gf._algos_for(tuple(bounds))
        else:
            bounds, algos = list(gf._lazy_bounds), gf._lazy_algos
        tasks = make_tasks(bounds, algos)
        tail = resolve_pipeline_tail(gf, tasks)
        return StepPlan(mode=cfg.mode, payload_elems=pool.size,
                        tasks=_tag_tail(tasks, tail),
                        update_spans=tuple(bounds), pipeline_tail=tail,
                        **common)
    assert cfg.mode == "csc", cfg.mode
    stage = stage or gf.stages[-1]
    k = stage.num_selected
    csc = dict(num_selected=k, chunk_elems=cfg.chunk_elems)
    if k >= gf.num_chunks:
        # Dense warm-up: the full pool in lazy buckets, plus the census.
        return StepPlan(mode="csc", payload_elems=pool.size,
                        tasks=make_tasks(gf._lazy_bounds, gf._lazy_algos),
                        update_spans=tuple(gf._lazy_bounds), warmup=True,
                        **csc, **common)
    wire_bounds = csc_mod.wire_bucket_boundaries(k, cfg.chunk_elems,
                                                 gf.bucket_elems)
    return StepPlan(mode="csc", payload_elems=k * cfg.chunk_elems,
                    tasks=make_tasks(wire_bounds, gf._algos_for(wire_bounds),
                                     spans=False),
                    update_spans=tuple(pool.bucket_boundaries(
                        gf.bucket_elems)), **csc, **common)


class InflightLane(NamedTuple):
    """The cross-step pipeline's lane: the f32 mean of each deferred
    tail bucket (unscaled: a guarded step divides the loss scale out
    before it parks them), the emitting step's learning rate and its
    verdict. ``ok`` false applies nothing: the window's first lane
    (``OverlapEngine.empty_inflight``) or a guarded step that tripped,
    whose deferred buckets join its atomic skip."""

    segs: Tuple[torch.Tensor, ...]
    lr: torch.Tensor     # f32, 0-dim
    ok: torch.Tensor     # bool, 0-dim


class OverlapEngine:
    """Executes a StepPlan as a software pipeline of per-bucket
    all-reduces and fused optimizer updates."""

    def __init__(self, gf, opt_name: str, opt_cfg, lars=None):
        if opt_name not in ("momentum_sgd", "lars", "adamw"):
            raise ValueError(f"unknown optimizer {opt_name}")
        self.gf = gf
        self.pool = gf.pool
        self.opt_name = opt_name
        self.opt_cfg = opt_cfg
        self.lars = lars

    def plan_for(self, stage=None) -> StepPlan:
        return self.gf.plan(stage)

    def replan(self, topology=None, *, num_data_shards=None,
               reduce_axes=None) -> None:
        """Re-resolve the backend's layout for a new topology (delegates
        to ``GradientFlow.replan``): θ re-tuned, per-bucket algorithms
        re-selected, plan cache invalidated. The next ``plan_for``
        returns a plan stamped with the new layout key."""
        self.gf.replan(topology, num_data_shards=num_data_shards,
                       reduce_axes=reduce_axes)

    def run(self, plan: StepPlan, gpool: torch.Tensor, params_tree,
            opt_state, gfstate, lr: torch.Tensor, census=None):
        """One pipelined reduce+update phase. ``gpool`` is the local
        gradient pool, already packed: in the wire dtype for dense and
        lazy, in f32 for CSC (hg is added before the wire cast) and for
        the low-bit wires (the residual is added before the quantize).
        ``census`` is the pack's chunk-L1 census of ``gpool`` (low-bit
        dense and lazy; taken here when None). The parameters and the
        optimizer state are updated in place (see ``kernels.pool_unpack``);
        CSC and the low-bit wires also work in place on ``gpool`` and on
        ``gfstate``'s tensors. Returns (params_tree, opt_state, gfstate)."""
        use_k = self.gf.cfg.use_kernels
        master, _ = self.pool.pack(params_tree, dtype=torch.float32,
                                   use_kernels=use_k)
        leaves = self.pool.flat_leaves(params_tree)
        if plan.mode == "csc":
            run = self._run_csc_warmup if plan.warmup else self._run_csc
            outs, gfstate = run(plan, gpool, master, leaves, opt_state,
                                gfstate, lr)
        elif self.gf.wire_spec is not None:
            outs = self._run_quantized_pool(plan, gpool, master, leaves,
                                            opt_state, gfstate, lr, census)
        else:
            outs = self._run_pool_pipeline(plan, gpool, master, leaves,
                                           opt_state, lr)
        return self._assemble(outs), opt_state, gfstate

    def run_guarded(self, plan: StepPlan, gpool: torch.Tensor, params_tree,
                    opt_state, gfstate, scaler_state, lr: torch.Tensor,
                    census=None):
        """``run`` under the numeric guard. ``gpool`` arrives scaled by
        ``scaler_state.scale`` (the loss was): dense and lazy keep the
        scale on the wire and unscale each reduced mean before its update;
        CSC unscales at entry, so ``hg`` stays scale-free across backoffs;
        the low-bit residual is stored unscaled. A tripped step writes no
        parameter, optimizer state, ``hg``, chunk norm or residual: only
        the scaler advances. Returns (params_tree, opt_state, gfstate, new
        scaler state, HealthFlags)."""
        from repro_torch.core import guard as guard_mod
        from repro_torch.optim import scaler as scaler_mod

        cfg = self.gf.cfg
        assert cfg.guard is not None, "run_guarded needs a GuardConfig"
        limit = guard_mod.overflow_limit(cfg.guard, cfg.wire_dtype)
        master, _ = self.pool.pack(params_tree, dtype=torch.float32,
                                   use_kernels=cfg.use_kernels)
        leaves = self.pool.flat_leaves(params_tree)
        scale = scaler_state.scale
        if plan.mode == "csc":
            run = self._guarded_csc_warmup if plan.warmup \
                else self._guarded_csc
            outs, flags = run(plan, gpool, master, leaves, opt_state,
                              gfstate, scale, lr, limit)
        elif self.gf.wire_spec is not None:
            outs, flags = self._guarded_quantized_pool(
                plan, gpool, master, leaves, opt_state, gfstate, scale, lr,
                limit, census)
        else:
            outs, flags, _ = self._guarded_pool(plan, gpool, master, leaves,
                                                opt_state, scale, lr, limit)
        new_scaler = scaler_mod.update(scaler_state,
                                       ~guard_mod.tripped(flags), cfg.guard)
        return (self._assemble(outs), opt_state, gfstate, new_scaler,
                flags)

    def _issue_all(self, plan, pool, wire_dtype=None, mean_out=None
                   ) -> List[torch.Tensor]:
        """Every task's collective issued before the first is waited on;
        the f32 means in task order, each written into ``mean_out`` (a
        pool-sized f32 tensor, may be ``pool``) when it is given."""
        issued = [lazy_mod.issue_bucket(pool, t.start, t.end, wire_dtype,
                                        algo=t.algo,
                                        topo=self.gf.cfg.topology)
                  for t in plan.tasks]
        means = []
        for t, p in zip(plan.tasks, issued):
            mean = p.wait() / plan.num_data_shards
            if mean_out is not None:
                mean = mean_out[t.start:t.end].copy_(mean)
            means.append(mean)
        return means

    def _guarded_pool(self, plan, gpool, master, leaves, opt_state, scale,
                      lr, limit, defer=None):
        """Dense/lazy: reduce every bucket of the scaled wire pool, take
        each mean's health word (the all-reduce mixed every rank's words
        in, so every rank reaches the same verdict with no extra
        collective), unscale the means in place, then every span's update
        behind ``ok``. With ``defer`` (a dict) a ``commit_epoch=1`` task's
        unscaled mean goes there instead, keyed by its index, and its span
        is left as it is. Returns (outs, flags, ok)."""
        from repro_torch.core import guard as guard_mod

        means = self._issue_all(plan, gpool)
        flags, ok = guard_mod.group_verdict(guard_mod.flags_from_words(
            [guard_mod.health_word(m) for m in means], limit),
            self.gf.model_axis)
        outs = []
        for t in plan.tasks:
            mean = means[t.index].div_(scale)
            if defer is not None and t.commit_epoch:
                defer[t.index] = mean
                outs.append(self._span_leaves(t.update_span, leaves))
            else:
                outs.append(self._update_span((t.start, t.end), mean, master,
                                              leaves, opt_state, lr, ok=ok))
        return outs, flags, ok

    # -- the low-bit wires ----------------------------------------------------

    def _dequant(self, scales):
        """Each bucket's scaled-domain mean back to gradient units, in
        place, as it retires."""
        chunk = self.gf.cfg.chunk_elems
        return lambda mean, task: wire_mod.dequantize_segment(
            mean, scales, task.start, task.end, chunk)

    def _run_quantized_pool(self, plan, gpool, master, leaves, opt_state,
                            gfstate, lr, census):
        """Dense/lazy on a low-bit wire: quantize the whole pool once, the
        new residual written over the old one (its old value is already
        in ``gpool``), then the staged loop on the 1-byte words, each
        bucket's mean dequantized as it retires."""
        out = gfstate.residual if self.gf.cfg.feedback_enabled else None
        q, _, scales, _ = self.gf.quantize(gpool, gfstate, census=census,
                                           out=out)
        return self._run_pool_pipeline(plan, q, master, leaves, opt_state,
                                       lr, xform=self._dequant(scales))

    def _guarded_quantized_pool(self, plan, gpool, master, leaves,
                                opt_state, gfstate, scale, lr, limit,
                                census):
        """Guarded twin of ``_run_quantized_pool``. The low-bit words
        saturate at the grid's clip instead of overflowing, so the reduced
        payload cannot carry the poison: the census sum is the health
        channel (a rank's NaN or Inf taints its chunk's L1, and the sum
        the scales need already makes the verdict global: no extra
        collective). Every bucket's reduce is issued, then the updates
        behind ``ok``; the new residual, built in a buffer of its own, is
        committed with ``commit_where``, so a tripped step keeps the old
        one bit for bit."""
        from repro_torch.core import guard as guard_mod

        q, err, scales, census_sum = self.gf.quantize(
            gpool, gfstate, census=census, loss_scale=scale,
            out=torch.empty_like(gpool))
        flags, ok = guard_mod.group_verdict(
            guard_mod.flags_from_census(census_sum, limit),
            self.gf.model_axis)
        means = self._issue_all(plan, q)
        dequant = self._dequant(scales)
        outs = [self._update_span((t.start, t.end),
                                  dequant(means[t.index], t).div_(scale),
                                  master, leaves, opt_state, lr, ok=ok)
                for t in plan.tasks]
        if self.gf.cfg.feedback_enabled:
            guard_mod.commit_where(ok, (err.div_(scale),),
                                   (gfstate.residual,))
        return outs, flags

    def _guarded_csc(self, plan, g, master, leaves, opt_state, gfstate,
                     scale, lr, limit):
        """Sparse CSC under the guard: ``g = gpool / scale + hg`` in place
        on the staging pool, then ``_run_csc``'s selection, gather,
        bucketed reduce and scatter, and its summed census, which is the
        health channel (a NaN or Inf anywhere in the post-reduce pool,
        sent chunks and kept ones alike, taints its chunk's sum). The
        masked updates run behind ``ok``; the new ``hg`` (computed last,
        in ``g``, which the next pack overwrites) and the census are
        committed with ``commit_where``, so on a trip the selection basis
        keeps its pre-step values and no NaN reaches ``select_chunks``.

        On a low-bit wire the limit is per chunk (``guard.per_chunk_limit``
        against the previous norms, the scales' basis): a chunk whose send
        census jumps far past it saturates the grid, which the int8 clip
        never shows as an Inf. The residual's selected chunks take the
        step's error only on a clean step."""
        from repro_torch.core import guard as guard_mod

        cfg = self.gf.cfg
        chunk = plan.chunk_elems
        g.div_(scale).add_(gfstate.hg)
        idx, chunk_mask = csc_mod.select_chunks(csc_mod.selection_basis(
            gfstate.chunk_norms, self.gf.model_axis), plan.num_selected)
        elem_mask = csc_mod.element_mask(chunk_mask, chunk)
        sent = self._csc_exchange(plan, g, idx, gfstate)
        if sent is not None:
            limit = guard_mod.per_chunk_limit(gfstate.chunk_norms,
                                              cfg.guard, limit)
        norms = csc_mod.summed_census(g, chunk, cfg.use_kernels,
                                      sent)
        flags, ok = guard_mod.group_verdict(
            guard_mod.flags_from_census(norms, limit), self.gf.model_axis)
        outs = [self._update_span(span, g[span[0]:span[1]], master, leaves,
                                  opt_state, lr, elem_mask[span[0]:span[1]],
                                  ok=ok)
                for span in plan.update_spans]
        hg_new = g.mul_(cfg.momentum).masked_fill_(elem_mask, 0.0)
        guard_mod.commit_where(ok, (hg_new, norms),
                               (gfstate.hg, gfstate.chunk_norms))
        if sent is not None and cfg.feedback_enabled:
            rows = gfstate.residual.view(-1, chunk)
            rows.index_copy_(0, idx, torch.where(
                ok, sent[2].view(-1, chunk), rows.index_select(0, idx)))
        return outs, flags

    def _guarded_csc_warmup(self, plan, g, master, leaves, opt_state,
                            gfstate, scale, lr, limit):
        """CSC's dense warm-up under the guard: the unscaled hg-corrected
        pool reduced in lazy buckets, each mean written back into ``g``;
        the summed census of the mean pool is the health channel; the
        updates behind ``ok``, then the census committed and ``hg``
        zeroed, each only on a clean step."""
        from repro_torch.core import guard as guard_mod

        cfg = self.gf.cfg
        g.div_(scale).add_(gfstate.hg)
        self._issue_all(plan, g, getattr(torch, cfg.wire_dtype), mean_out=g)
        norms = csc_mod.summed_census(g, plan.chunk_elems, cfg.use_kernels)
        flags, ok = guard_mod.group_verdict(
            guard_mod.flags_from_census(norms, limit), self.gf.model_axis)
        outs = [self._update_span(span, g[span[0]:span[1]], master, leaves,
                                  opt_state, lr, ok=ok)
                for span in plan.update_spans]
        gfstate.hg.masked_fill_(ok, 0.0)
        guard_mod.commit_where(ok, (norms,), (gfstate.chunk_norms,))
        return outs, flags

    def _run_pool_pipeline(self, plan, gpool, master, leaves, opt_state, lr,
                           wire_dtype=None, mean_out=None, xform=None,
                           defer=None) -> List[Any]:
        """Issue reduce_i, then launch update_{i-1} while it is in flight;
        wait on each bucket just before its own update. ``wire_dtype``
        casts each bucket before its all-reduce (None: ``gpool`` is
        already in the wire dtype); ``mean_out`` (a pool-sized f32 tensor,
        may be ``gpool``) receives each bucket's mean; ``xform(mean,
        task)`` maps each mean before its update (the low-bit wires'
        dequantization). With ``defer`` (a dict) a ``commit_epoch=1``
        task's mean goes there, keyed by its index, instead of into an
        update: its span is left as it is."""
        outs: List[Any] = [None] * len(plan.tasks)

        def retire(task, issued):
            mean = issued.wait() / plan.num_data_shards
            if xform is not None:
                mean = xform(mean, task)
            if mean_out is not None:
                mean = mean_out[task.start:task.end].copy_(mean)
            if defer is not None and task.commit_epoch:
                defer[task.index] = mean
                outs[task.index] = self._span_leaves(task.update_span, leaves)
                return
            outs[task.index] = self._update_span(
                (task.start, task.end), mean, master, leaves, opt_state, lr)

        pending = None
        for task in plan.tasks:
            issued = lazy_mod.issue_bucket(gpool, task.start, task.end,
                                           wire_dtype, algo=task.algo,
                                           topo=self.gf.cfg.topology)
            if pending is not None:
                retire(*pending)
            pending = (task, issued)
        retire(*pending)
        return outs

    def _run_csc(self, plan, g, master, leaves, opt_state, gfstate, lr):
        """Sparse CSC stage (Algorithm 1 with the collectives pipelined):
        re-inject hg, select k chunks from the previous norms, gather them
        into the wire buffer, all-reduce it in θ buckets with bucket i in
        flight while bucket i-1 is scattered back, then the new hg, the
        summed census, and the masked update per span.

        ``g`` is the f32 staging pool, which the next step's pack
        overwrites, so it becomes the post-reduce pool in place, and
        ``gfstate.hg`` is overwritten with the new hg (and the residual's
        selected chunks with this step's error). The update reads
        its gradients from the post-reduce pool too, with the mask: where
        it is false the update keeps the master and the state whatever
        the gradient, and LARS's norms zero the gradient first, so the
        JAX package's separate zero-filled update pool (one more
        pool-sized buffer and scatter) would give the same bits."""
        cfg = self.gf.cfg
        chunk = plan.chunk_elems
        g.add_(gfstate.hg)
        idx, chunk_mask = csc_mod.select_chunks(csc_mod.selection_basis(
            gfstate.chunk_norms, self.gf.model_axis), plan.num_selected)
        elem_mask = csc_mod.element_mask(chunk_mask, chunk)
        sent = self._csc_exchange(plan, g, idx, gfstate)
        if sent is not None and cfg.feedback_enabled:
            gfstate.residual.view(-1, chunk).index_copy_(
                0, idx, sent[2].view(-1, chunk))
        hg = torch.mul(g, cfg.momentum, out=gfstate.hg)
        hg.masked_fill_(elem_mask, 0.0)
        norms = csc_mod.summed_census(g, chunk, cfg.use_kernels,
                                      sent)
        outs = [self._update_span(span, g[span[0]:span[1]], master, leaves,
                                  opt_state, lr, elem_mask[span[0]:span[1]])
                for span in plan.update_spans]
        return outs, gfstate._replace(hg=hg, chunk_norms=norms)

    def _csc_exchange(self, plan, g, idx, gfstate):
        """Gather the selected chunks ``idx`` of ``g`` into the wire buffer,
        all-reduce it in θ buckets with bucket i in flight while bucket
        i-1's mean is scattered back into ``g``.

        On a low-bit wire the selected chunks of ``g`` first take the
        residual's (in place: the scatter overwrites them, and hg and the
        census never read them), the buffer is quantized with scales from
        ``gfstate.chunk_norms`` at ``idx``, and each bucket is dequantized
        before its scatter. Returns (idx, the pre-quantization send
        census, the error of the selected chunks), or None on the native
        wire."""
        cfg = self.gf.cfg
        chunk = plan.chunk_elems
        spec = self.gf.wire_spec
        rows = g.view(-1, chunk)
        if spec is not None and cfg.feedback_enabled:
            rows.index_add_(0, idx, gfstate.residual.view(-1, chunk)
                            .index_select(0, idx))
        with trace.span("gf.gather"):
            if cfg.use_kernels:
                from repro_torch.kernels import ops
                wire = ops.csc_compact(g, idx, chunk)
            else:
                wire = csc_mod.compact_chunks(g, idx, chunk)
        wire_dtype, dequant, sent = getattr(torch, cfg.wire_dtype), None, None
        if spec is not None:
            wire, err, scales, send_l1 = csc_mod.quantize_selection(
                wire, gfstate.chunk_norms, idx, chunk, spec,
                plan.num_data_shards, cfg.use_kernels)
            wire_dtype, dequant = None, self._dequant(scales)
            sent = (idx, send_l1, err)

        def scatter(task, issued):
            mean = issued.wait() / plan.num_data_shards
            with trace.span("gf.scatter"):
                if dequant is not None:
                    mean = dequant(mean, task)
                ids = idx[task.start // chunk:task.end // chunk]
                rows.index_copy_(0, ids, mean.view(-1, chunk))

        pending = None
        for task in plan.tasks:
            issued = lazy_mod.issue_bucket(wire, task.start, task.end,
                                           wire_dtype, algo=task.algo,
                                           topo=cfg.topology)
            if pending is not None:
                scatter(*pending)
            pending = (task, issued)
        scatter(*pending)
        return sent

    def _run_csc_warmup(self, plan, g, master, leaves, opt_state, gfstate,
                        lr):
        """CSC's dense warm-up stage: the hg-corrected f32 pool reduced in
        lazy buckets (each cast to the wire dtype) pipelined against the
        update, then the census of the mean pool, which keeps the norms
        tracking for the sparse handoff. Each bucket's mean is written
        back into ``g`` (the staging pool) so the census needs no
        pool-sized copy; hg is zeroed in place."""
        cfg = self.gf.cfg
        g.add_(gfstate.hg)
        outs = self._run_pool_pipeline(plan, g, master, leaves, opt_state,
                                       lr, wire_dtype=getattr(
                                           torch, cfg.wire_dtype),
                                       mean_out=g)
        norms = csc_mod.summed_census(g, plan.chunk_elems,
                                       cfg.use_kernels)
        return outs, gfstate._replace(hg=gfstate.hg.zero_(),
                                      chunk_norms=norms)

    # -- the cross-step pipeline ----------------------------------------------

    def empty_inflight(self, plan: StepPlan, device=None) -> InflightLane:
        """The window's first lane: zero segments, ``ok`` false (nothing
        to apply), shaped like every lane ``run_pipelined`` emits. The
        segments are f32, guarded or not: the mean the in-step update
        reads, so the deferred update's input is the unpipelined one's
        bit for bit (the JAX package carries the wire dtype unguarded)."""
        return InflightLane(
            segs=tuple(torch.zeros((t.size,), dtype=torch.float32,
                                   device=device)
                       for t in plan.tail_tasks),
            lr=torch.zeros((), dtype=torch.float32, device=device),
            ok=torch.zeros((), dtype=torch.bool, device=device))

    def apply_inflight(self, plan: StepPlan, params_tree, opt_state,
                       lane: InflightLane):
        """Update each deferred span from the lane, in place: the
        previous step's tail buckets, before this step's forward pass
        reads their parameters (and at a window's edge, its flush). Each
        span is one ``pool_unpack_update`` over the span's f32 masters
        (``_view_master``) with the lane's mean, the emitting step's
        ``lr``, an all-true mask and the lane's ``ok`` as the kernel's
        predicate: a first or rejected lane writes nothing. The inputs
        are the unpipelined in-step update's, so the bits are too.
        Returns (params_tree, opt_state)."""
        if not plan.pipeline_tail:
            return params_tree, opt_state
        with trace.span("gf.apply_inflight"):
            leaves = self.pool.flat_leaves(params_tree)
            for task, mean in zip(plan.tail_tasks, lane.segs):
                view = self.pool.bucket_view(*task.update_span)
                self._update_view_seg(view, self._view_master(view, leaves),
                                      mean, opt_state, lane.lr, None,
                                      leaves[view.leaf_lo:view.leaf_hi],
                                      ok=lane.ok)
        return params_tree, opt_state

    def _view_master(self, view, leaves) -> torch.Tensor:
        """The f32 masters of one view: its own leaves packed (through
        ``pool_pack``, the kernel with ``use_kernels``), its padding zero:
        the bits of ``pool.pack(params)[start:end]``, without packing the
        rest of the pool."""
        own = leaves[view.leaf_lo:view.leaf_hi]
        if self.gf.cfg.use_kernels:
            from repro_torch.kernels import ops
            return ops.pool_pack(own, view.offsets, view.sizes, view.size,
                                 0, torch.float32)[0]
        return ref.pool_pack(own, view.offsets, view.size, 0,
                             torch.float32)[0]

    def _span_leaves(self, span, leaves):
        """A deferred task's share of the step: its span's leaves, as
        they are (the JAX package's identity span)."""
        view = self.pool.bucket_view(*span)
        return leaves[view.leaf_lo:view.leaf_hi]

    @staticmethod
    def _lane(tail: Dict[int, torch.Tensor], plan, lr, ok) -> InflightLane:
        return InflightLane(
            segs=tuple(tail[t.index] for t in plan.tail_tasks),
            lr=torch.as_tensor(lr, dtype=torch.float32).to(ok.device), ok=ok)

    def run_pipelined(self, plan: StepPlan, gpool: torch.Tensor, params_tree,
                      opt_state, gfstate, lr):
        """``run`` with the plan's deferred tail: the same collectives in
        the same order and the head spans' updates in the step; the tail
        buckets' means go into the returned lane, which the caller applies
        at the start of the next step (``apply_inflight``) and at the
        window's edge. Native dense and lazy only. Returns (params_tree,
        opt_state, gfstate, lane)."""
        assert plan.pipeline_tail and plan.mode in ("dense", "lazy") \
            and self.gf.wire_spec is None, plan
        master, _ = self.pool.pack(params_tree, dtype=torch.float32,
                                   use_kernels=self.gf.cfg.use_kernels)
        leaves = self.pool.flat_leaves(params_tree)
        tail: Dict[int, torch.Tensor] = {}
        outs = self._run_pool_pipeline(plan, gpool, master, leaves,
                                       opt_state, lr, defer=tail)
        ok = torch.ones((), dtype=torch.bool, device=master.device)
        return (self._assemble(outs), opt_state, gfstate,
                self._lane(tail, plan, lr, ok))

    def run_pipelined_guarded(self, plan: StepPlan, gpool: torch.Tensor,
                              params_tree, opt_state, gfstate, scaler_state,
                              lr):
        """``run_pipelined`` under the guard (``_guarded_pool``): every
        bucket, the deferred ones too, is reduced before the verdict,
        which gates both commit epochs: the head spans' updates run behind
        ``ok`` and the lane carries ``ok``, so a tripped step's deferred
        segments are rejected at the next step's start. The segments are
        unscaled when parked, so a backoff in between cannot skew them.
        Returns (params_tree, opt_state, gfstate, new scaler state, lane,
        HealthFlags)."""
        from repro_torch.core import guard as guard_mod
        from repro_torch.optim import scaler as scaler_mod

        cfg = self.gf.cfg
        assert cfg.guard is not None, \
            "run_pipelined_guarded needs a GuardConfig"
        assert plan.pipeline_tail and plan.mode in ("dense", "lazy") \
            and self.gf.wire_spec is None, plan
        limit = guard_mod.overflow_limit(cfg.guard, cfg.wire_dtype)
        master, _ = self.pool.pack(params_tree, dtype=torch.float32,
                                   use_kernels=cfg.use_kernels)
        leaves = self.pool.flat_leaves(params_tree)
        tail: Dict[int, torch.Tensor] = {}
        outs, flags, ok = self._guarded_pool(
            plan, gpool, master, leaves, opt_state, scaler_state.scale, lr,
            limit, defer=tail)
        new_scaler = scaler_mod.update(scaler_state, ok, cfg.guard)
        return (self._assemble(outs), opt_state, gfstate, new_scaler,
                self._lane(tail, plan, lr, ok), flags)

    def _update_span(self, span, red_seg, master, leaves, opt_state, lr,
                     mask=None, ok=None):
        """One update span's fused optimizer step on the span's segments;
        the new values land in the span's parameter leaves and in the
        optimizer state's slices. ``mask`` is the span's bool segment
        (CSC's selected chunks); None updates every element. ``ok``: the
        guard's device verdict; when false nothing is written. Returns the
        span's leaves."""
        start, end = span
        view = self.pool.bucket_view(start, end)
        return self._update_view_seg(view, master[start:end], red_seg,
                                     opt_state, lr, mask,
                                     leaves[view.leaf_lo:view.leaf_hi], ok)

    def _update_view_seg(self, view, m_seg, red_seg, opt_state, lr, mask,
                         out_leaves, ok=None):
        """The update on one view: every pool-sized state leaf sliced to
        the span, LARS's trust ratios of the view's tensors (the masked
        gradient's norms) handed to the kernel as ``ratios`` with
        ``use_kernels``, else expanded into the per-element ``scale``."""
        from repro_torch import optim

        use_k = self.gf.cfg.use_kernels
        with trace.span("gf.update"):
            st_seg = opt_state.__class__(*(x[view.start:view.end]
                                           for x in opt_state))
            scale = ratios = None
            if self.lars is not None:
                ratios = self.lars.ratios_view(view, m_seg, red_seg,
                                               self.opt_cfg, mask)
                if not use_k:
                    scale = ref.expand_ratios(ratios, view.sizes, view.size)
                    ratios = None
            if mask is None:
                mask = torch.ones((view.size,), dtype=torch.bool,
                                  device=m_seg.device)
            new_leaves, _ = optim.update_view(
                self.opt_name, view, m_seg, red_seg, st_seg, mask,
                self.opt_cfg, lr, scale=scale, ratios=ratios,
                use_kernels=use_k, out_leaves=out_leaves, ok=ok)
        return new_leaves

    def _assemble(self, outs):
        """The per-span leaves back into the parameter tree."""
        all_leaves = [leaf for leaves in outs for leaf in leaves]
        assert len(all_leaves) == self.pool.num_tensors, (
            len(all_leaves), self.pool.num_tensors)
        return self.pool.unflatten(all_leaves)


# -- the analytic twin (timeline simulation) ---------------------------------
#
# Pure cost-model arithmetic on a StepPlan and a Topology: no pool is
# allocated and nothing runs on a device, so a wire dtype the pool refuses
# on the card (the paper's float16) prices here all the same. The formulas
# and their order are the JAX package's, so the floats are its floats.


def wire_itemsize(wire_dtype: str) -> int:
    """Bytes of one wire element, from the dtype's name."""
    return getattr(torch, str(wire_dtype)).itemsize


def simulate_plan(plan: StepPlan, topo, *,
                  backward_s: Optional[float] = None,
                  hbm_bw: float = cost_model.HBM_BW) -> dict:
    """Price a StepPlan on a Topology with the cost model's two-engine
    timeline: per-bucket comm times from each task's own algorithm,
    releases at the uniform backward rate, update times from the HBM
    sweep model. Returns {rows, summary, backward_s, monolithic_finish_s}:
    ``monolithic_finish_s`` is the same buckets without the staged update
    (comm finishes, then one barrier update sweep), the number the
    pipeline must beat."""
    elt = wire_itemsize(plan.wire_dtype)
    sizes = [t.size * elt for t in plan.tasks]
    if backward_s is None:
        backward_s = cost_model.ring_allreduce_time(
            plan.payload_elems * elt, topo.num_devices, topo.slowest_fabric)
    comm = [t.algo.predicted_time(b, topo) for t, b in zip(plan.tasks,
                                                           sizes)]
    rel = cost_model.bucket_release_times(sizes, backward_s)
    if plan.mode == "csc" and not plan.warmup:
        # The update side is its own segmented pass (spans != tasks):
        # charge it as one post-comm sweep of the pool.
        upd = [0.0] * len(plan.tasks)
        rows = cost_model.staged_timeline(comm, rel, upd)
        tail = cost_model.update_time(plan.pool_size, hbm_bw)
        finish = rows[-1].update_end_s + tail if rows else backward_s
        summary = cost_model.timeline_summary(rows, backward_s)
        summary["finish_s"] = finish
        mono = finish
    else:
        upd = [cost_model.update_time(t.size, hbm_bw) for t in plan.tasks]
        rows = cost_model.staged_timeline(comm, rel, upd)
        summary = cost_model.timeline_summary(rows, backward_s)
        mono = cost_model.overlapped_finish_time(comm, rel) + sum(upd)
    return {"rows": rows, "summary": summary, "backward_s": backward_s,
            "monolithic_finish_s": mono}


def render_timeline(plan: StepPlan, topo, *,
                    backward_s: Optional[float] = None) -> str:
    """The plan's compute/comm timeline as text (``dryrun --timeline``):
    per-bucket comm and update start and end in ms, each bucket's exposed
    comm, and the overlap-efficiency summary."""
    sim = simulate_plan(plan, topo, backward_s=backward_s)
    rows, summary = sim["rows"], sim["summary"]
    bw = sim["backward_s"]
    ms = 1e3
    lines = [
        f"StepPlan[{plan.mode}{' warmup' if plan.warmup else ''}] "
        f"{len(plan.tasks)} buckets, payload "
        f"{plan.payload_elems * wire_itemsize(plan.wire_dtype) / 2**20:.1f}"
        f" MiB ({plan.wire_dtype}) over {topo.num_devices} devices",
        f"{'bkt':>3} {'elems':>10} {'algo':>11} {'rel':>8} "
        f"{'comm_start':>10} {'comm_end':>9} {'upd_start':>9} "
        f"{'upd_end':>8} {'exposed':>8}   (ms)",
    ]
    for t, r in zip(plan.tasks, rows):
        lines.append(
            f"{r.index:>3} {t.size:>10} {t.algo.name:>11} "
            f"{r.release_s * ms:>8.2f} {r.comm_start_s * ms:>10.2f} "
            f"{r.comm_end_s * ms:>9.2f} {r.update_start_s * ms:>9.2f} "
            f"{r.update_end_s * ms:>8.2f} "
            f"{r.exposed_comm_s(bw) * ms:>8.2f}")
    lines.append(
        f"backward {bw * ms:.2f} ms | finish {summary['finish_s'] * ms:.2f}"
        f" ms (monolithic {sim['monolithic_finish_s'] * ms:.2f} ms) | "
        f"comm busy {summary['comm_busy_s'] * ms:.2f} ms | exposed comm "
        f"{summary['exposed_comm_s'] * ms:.2f} ms | overlap efficiency "
        f"{summary['overlap_efficiency'] * 100:.1f}%")
    return "\n".join(lines)


def simulate_plan_pipelined(plan: StepPlan, topo, *,
                            tail: Optional[int] = None,
                            backward_s: Optional[float] = None,
                            hbm_bw: float = cost_model.HBM_BW) -> dict:
    """Price the cross-step pipelined execution of a dense or lazy plan:
    the cost model's two-row timeline where the last ``tail`` buckets'
    updates retire during the next step's forward window, each gated by
    its span's forward need-time. ``tail`` defaults to the plan's own
    ``pipeline_tail`` (picked by the cost model when that is 0: the
    what-if the dryrun table shows). Returns ``cross_step_timeline``'s
    dict plus the staged (within-step) baseline."""
    assert plan.mode in ("dense", "lazy") or plan.warmup, plan.mode
    elt = wire_itemsize(plan.wire_dtype)
    sizes = [t.size * elt for t in plan.tasks]
    if backward_s is None:
        backward_s = cost_model.ring_allreduce_time(
            plan.payload_elems * elt, topo.num_devices, topo.slowest_fabric)
    comm = [t.algo.predicted_time(b, topo) for t, b in zip(plan.tasks,
                                                           sizes)]
    rel = cost_model.bucket_release_times(sizes, backward_s)
    upd = [cost_model.update_time(t.size, hbm_bw) for t in plan.tasks]
    if tail is None:
        tail = plan.pipeline_tail or cost_model.select_pipeline_tail(
            comm, rel, upd, backward_s)
    sim = cost_model.cross_step_timeline(comm, rel, upd, tail, backward_s)
    sim["backward_s"] = backward_s
    sim["staged_finish_s"] = cost_model.staged_finish_time(comm, rel, upd)
    rows = cost_model.staged_timeline(comm, rel, upd)
    sim["staged_exposed_comm_s"] = cost_model.timeline_summary(
        rows, backward_s)["exposed_comm_s"]
    return sim


def render_cross_step_timeline(plan: StepPlan, topo, *,
                               backward_s: Optional[float] = None) -> str:
    """The cross-step (two-row) schedule as text: one steady-state step
    with the carried tail applied up front, the head buckets committing
    in the step, and the new tail handed to step t+1 (the second table
    ``launch/dryrun.py --timeline`` prints for pipelineable plans)."""
    sim = simulate_plan_pipelined(plan, topo, backward_s=backward_s)
    ms = 1e3
    lines = [
        f"cross-step pipeline: tail={sim['tail']} of {len(plan.tasks)} "
        f"buckets deferred into the scan carry",
        f"{'bkt':>3} {'lane':>8} {'comm_start':>10} {'comm_end':>9} "
        f"{'retire':>8}   (ms)",
    ]
    for idx, deferred, cs, ce, retire in sim["rows"]:
        lane = "carry" if deferred else "in-step"
        lines.append(f"{idx:>3} {lane:>8} {cs * ms:>10.2f} "
                     f"{ce * ms:>9.2f} {retire * ms:>8.2f}")
    lines.append(
        f"steady-state period {sim['period_s'] * ms:.2f} ms vs staged "
        f"{sim['staged_finish_s'] * ms:.2f} ms | exposed comm "
        f"{sim['exposed_comm_s'] * ms:.2f} ms vs staged "
        f"{sim['staged_exposed_comm_s'] * ms:.2f} ms | window prologue "
        f"{sim['prologue_s'] * ms:.2f} ms")
    return "\n".join(lines)

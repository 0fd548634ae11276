"""The training step: model + GradientFlow + optimizer, in PyTorch.

One step, as ``repro/launch/trainer.py`` runs it with the flat collective:

1. forward and backward on the f32 masters cast to ``compute_dtype``
   (explicit ``.to``, not autocast), so the gradients come back in f32;
2. ``GradientPool.pack_into`` writes them into the pool, in the staging
   buffer the previous step handed back (``TrainState.staging``): in the
   wire dtype for dense and lazy, in f32 for CSC, whose pool is padded to
   a chunk multiple, and in f32 for the low-bit wires (``wire_format``
   'int8' or 'fp8_e4m3', pool padded too), whose dense and lazy pack also
   takes the chunk-L1 census the wire scales come from;
3. ``overlap='staged'`` (the default): ``OverlapEngine.run`` packs the
   parameters into the f32 master pool, then per bucket: issue the
   all-reduce, update the previous bucket (for CSC: select, gather,
   reduce and scatter the chunks, then the census and the masked update;
   see ``core.engine``). ``overlap='monolithic'``: ``GradientFlow.reduce``
   reduces every bucket, then the masters are packed and one update of
   the whole pool runs.

The optimizer is momentum SGD, LARS (momentum SGD scaled by per-tensor
trust ratios: per span when staged, over the whole pool when monolithic)
or AdamW (plain PyTorch ops, no kernel, as in the JAX package).

The data-parallel topology comes from the world size (one ``('data', N)``
level) unless the config names one covering the same ranks; its level
groups, and on the card the ring workspace of each level group that a
``pallas_ring`` bucket may run over, are created when the trainer is.

CSC's step depends on its warm-up stage: ``build_train_step(stage)``
builds one step function per stage, and the caller picks the stage of
each step with ``gf.stage_for_step``. With ``use_kernels`` the packs, the
updates of SGD and LARS and CSC's gather and census go through
``kernels.ops``: the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors. The data-parallel group is the default
``torch.distributed`` group when one is initialised (each rank passes its
own batch shard to ``step``); with none, the step is one shard's.

With ``GradientFlowConfig.guard`` (the numeric guard rail, ``core.guard``)
the loss is multiplied by the live loss scale (``TrainState.guard``, an
``optim.scaler.ScalerState``) before the backward pass, the step issues
exactly the unguarded step's collectives, its verdict is a device flag
(the ``guard_tripped`` metric), and a tripped step leaves parameters,
optimizer state and CSC's state bit-identical; only the scaler advances.
``build_train_step(fault_hook=...)`` corrupts the packed pool before the
reduce (``runtime.faults``); the hook writes after the pack's census, so
a low-bit dense or lazy step then takes the census anew from the pool it
corrupted. Gradient accumulation is not ported yet.

``build_train_window(K)`` runs up to K steps as one unit, the port's form
of the JAX package's compile-once window (``launch.window``): on a CUDA
device the L <= K step bodies are one CUDA graph, captured at the first
call and replayed after it, with one host read of the stacked metrics a
window; on the CPU the same bodies run eagerly. With a deferred tail
(``GradientFlowConfig.pipeline_tail_buckets``, staged native dense or
lazy) and K > 1 each body first applies the previous step's lane
(``TrainState.inflight``) and parks its own tail in a new one; the
window starts from an empty lane and flushes the last before it returns,
so a state outside a window is always flushed (``assert_flushed``).

``replan(topology)`` re-resolves the collective layer for a new topology
over the same ranks (an elastic event); steps and windows built before it
refuse to run. A checkpoint restore (``checkpoint``) writes into the
state's tensors in place, so a captured window replays on it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import dataclasses

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core import guard as guard_mod
from repro_torch.core.engine import OverlapEngine
from repro_torch.core.gradientflow import GFState, GradientFlow, wire_dtype_of
from repro_torch.core.pool import GradientPool
from repro_torch.core.schedule import SparsityStage
from repro_torch.core.wire import chunk_l1 as wire_chunk_l1
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.optim import lr_at
from repro_torch.optim import scaler as scaler_mod
from repro_torch.optim.lars import LARSScaler
from repro_torch.parallel import collectives
from repro_torch.parallel.topology import mesh_topology

_ROADMAP = "is not ported to repro_torch yet; see ROADMAP.md queue A"


class TrainState(NamedTuple):
    params: Any          # nested dict of f32 master tensors
    opt: Any             # SGDState or AdamWState, pool-shaped tensors
    gf: GFState          # CSC: this rank's hg row and the chunk norms
    step: int
    guard: Any = ()      # the loss scaler's ScalerState when guarded
    staging: Any = None  # the pool buffer the next pack writes into
    # The cross-step pipeline's lane (core.engine.InflightLane), live only
    # between the step bodies of a pipelined window: every state a window
    # or a step returns carries the empty tuple.
    inflight: Any = ()


def is_flushed(state: TrainState) -> bool:
    """True when the state carries no live lane: every update a step
    emitted has been applied to the parameters."""
    return not state.inflight


def assert_flushed(state: TrainState, what: str = "checkpoint") -> None:
    """Refuse a state that carries a live lane: its deferred updates
    exist nowhere else, so saving or stepping it would drop them. A
    window flushes its lane before it returns."""
    if not is_flushed(state):
        raise ValueError(
            f"TrainState carries an in-flight pipeline lane; {what} needs "
            f"a flushed state (pass the state a window returned, not one "
            f"taken between its step bodies)")


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 device: Optional[Union[str, torch.device]] = None):
        gf_cfg = cfg.gradientflow
        if gf_cfg.overlap not in ("staged", "monolithic"):
            raise ValueError(f"unknown overlap {gf_cfg.overlap!r}")
        if cfg.microbatches != 1:
            raise NotImplementedError("gradient accumulation " + _ROADMAP)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model)
        self.num_data = collectives.data_world_size()
        gf_cfg = dataclasses.replace(gf_cfg, topology=mesh_topology(
            self.num_data, gf_cfg.topology))
        self._prepare_groups(gf_cfg)
        # CSC chunking and the low-bit wires' per-chunk scales both key
        # off whole chunks: pad the pool to a chunk multiple for either.
        pad = gf_cfg.chunk_elems \
            if (gf_cfg.csc_enabled or gf_cfg.quantized) else 1
        self.pool = GradientPool(self.model.param_shapes(), pad_to=pad)
        self.gf = GradientFlow(gf_cfg, self.pool, self.num_data)
        self.gf_cfg = gf_cfg
        # Steps and windows remember the count they were built at: one
        # built before a replan holds the old plan and refuses to run.
        self.replans = 0
        self.opt_name = cfg.optimizer.name
        self.lars = LARSScaler(self.pool) if self.opt_name == "lars" \
            else None
        self.engine = OverlapEngine(self.gf, self.opt_name, cfg.optimizer,
                                    lars=self.lars)
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)

    def _prepare_groups(self, gf_cfg) -> None:
        """The level groups of the config's topology and, when a bucket
        may run the ring, their ring workspaces (collectively: every rank
        calls this in one order)."""
        collectives.level_groups(gf_cfg.topology)
        # 'auto' resolves to the flat ring on one level (resolve_algorithm).
        if gf_cfg.collective_algo == "pallas_ring" or (
                gf_cfg.collective_algo == "auto"
                and len(gf_cfg.topology.levels) > 1):
            kops.ring_prepare(collectives.ring_levels(gf_cfg.topology),
                              self.device)

    def replan(self, topology=None) -> None:
        """Re-resolve the collective layer for a new topology over the
        same ranks (an elastic event): the data degree from the world
        size and ``topology`` (``mesh_topology``: one ('data', N) level
        when None), its level groups (``dist.new_group``: every rank
        calls this, in one order) and ring workspaces, then
        ``OverlapEngine.replan`` (θ re-tuned, algorithms re-selected, the
        plan cache cleared). Steps and windows built before hold the old
        plan and refuse to run: release the windows and build new ones.
        A new world size is a relaunch (``checkpoint.reshard``)."""
        self.num_data = collectives.data_world_size()
        topo = mesh_topology(self.num_data, topology)
        self._prepare_groups(dataclasses.replace(self.gf_cfg, topology=topo))
        self.engine.replan(topo, num_data_shards=self.num_data)
        self.gf_cfg = self.gf.cfg
        self.replans += 1

    def check_current(self, replans: int, what: str) -> None:
        """Refuse a step or window built before the last ``replan``."""
        if replans != self.replans:
            raise ValueError(f"this {what} was built before "
                             f"Trainer.replan and holds the old plan: build "
                             f"a new one")

    @property
    def _pack_dtype(self) -> torch.dtype:
        """Dense/lazy pack the gradients straight to the wire dtype; CSC
        packs to f32, because hg is added before the wire cast, and so do
        the low-bit wires, which quantize after the residual is added."""
        if self.gf_cfg.csc_enabled or self.gf_cfg.quantized:
            return torch.float32
        return wire_dtype_of(self.gf_cfg)

    @property
    def _census_chunk(self) -> int:
        """The pack's census chunk: the low-bit dense and lazy wires take
        their scales from it (one pass, no extra sweep); 0 otherwise."""
        return self.gf_cfg.chunk_elems \
            if self.gf_cfg.quantized and not self.gf_cfg.csc_enabled else 0

    def init_state(self, seed: int = 0,
                   params: Optional[Dict[str, Any]] = None) -> TrainState:
        """Fresh state: parameters from ``seed`` (or the given f32 tree,
        e.g. from ``convert.params_from_numpy``), the optimizer's zero
        state (SGD's momentum; AdamW's moments and counts), the loss
        scaler's initial state when guarded, zero staging buffer."""
        if params is None:
            params = self.model.init_params(seed, self.device)
        else:
            self.pool.flat_leaves(params)  # shape check
        return TrainState(
            params=params,
            opt=optim.init_state(self.opt_name, self.pool.size, self.device),
            gf=self.gf.init_state(self.device), step=0,
            guard=scaler_mod.init(self.gf_cfg.guard, self.device)
            if self.gf_cfg.guarded else (),
            staging=torch.zeros((self.pool.size,), dtype=self._pack_dtype,
                                device=self.device))

    def build_train_step(self, stage: Optional[SparsityStage] = None,
                         fault_hook: Optional[Callable] = None):
        """``step(state, batch) -> (state, metrics)`` under CSC stage
        ``stage`` (default: the steady one; dense and lazy have one).
        ``batch`` is this rank's {'tokens', 'labels'} (any device; moved to
        the trainer's). The returned state shares the parameter,
        optimizer-state and staging tensors of the one passed in (and
        CSC's hg, and guarded its chunk norms), which are updated in
        place. ``fault_hook(gpool, step)`` (``runtime.faults.make_hook``)
        may corrupt the packed local pool, in place, before its reduce;
        ``step`` is the host int ``state.step``. A plan with a deferred
        tail runs unpipelined here, as in the JAX package."""
        body = self._step_body(stage, fault_hook, pipelined=False)
        replans = self.replans

        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            self.check_current(replans, "train step")
            assert_flushed(state, "a train step")
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in batch.items()}
            lr = lr_at(self.cfg.optimizer, state.step)
            if self.device.type == "cuda":
                lr = lr.pin_memory().to(self.device, non_blocking=True)
            state, metrics = body(state, batch, lr, state.step)
            return state, self.reduce_metrics(metrics)

        return step

    def build_train_window(self, window_steps: int,
                           stage: Optional[SparsityStage] = None,
                           fault_hook: Optional[Callable] = None):
        """``window(state, batches) -> (state, metrics)``: up to
        ``window_steps`` steps under one stage as one unit
        (``launch.window.TrainWindow``). ``batches`` holds 'tokens' and
        'labels' stacked [L, b, s], L <= window_steps; the metrics come
        back stacked [L] (``guard_tripped`` too when guarded). The
        returned state is flushed and shares its tensors with the input
        state. On a CUDA device the L step bodies are one CUDA graph,
        captured at the first call for each L and replayed after it (a
        capture that fails raises; nothing falls back to the eager
        loop); on the CPU they run eagerly. ``fault_hook(gpool, step)``
        gets the step as a 0-dim tensor on the trainer's device. With a
        deferred tail and window_steps > 1 the bodies run the cross-step
        pipeline. On the card a step that would sum through a gloo group
        raises here (``launch.window.host_collectives``)."""
        from repro_torch.launch.window import TrainWindow

        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        plan = self._pipeline_plan(stage) if window_steps > 1 else None
        body = self._step_body(stage, fault_hook, pipelined=plan is not None)
        return TrainWindow(self, window_steps, body, plan,
                           self.engine.plan_for(stage))

    def _pipeline_plan(self, stage: Optional[SparsityStage] = None):
        """The plan a pipelined window runs, or None when the config does
        not pipeline (no deferred tail, monolithic overlap, CSC, a low-bit
        wire)."""
        if self.gf_cfg.overlap != "staged":
            return None
        plan = self.engine.plan_for(stage)
        return plan if plan.pipeline_tail else None

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The metrics' mean over the data-parallel ranks, in place (one
        all-reduce each). ``guard_tripped`` is the same on every rank
        already and takes none."""
        if self.num_data > 1:
            for k, v in metrics.items():
                if k != "guard_tripped":
                    collectives.all_reduce_sum(v)
                    v.div_(self.num_data)
        return metrics

    def _step_body(self, stage: Optional[SparsityStage],
                   fault_hook: Optional[Callable], pipelined: bool):
        """``body(state, batch, lr, step) -> (state, local metrics)``: one
        step on a batch already on the device, with its learning rate
        ``lr`` (f32) and ``step`` for the fault hook; the metrics are this
        rank's (``reduce_metrics`` averages them). ``pipelined``: apply
        ``state.inflight`` first, then run the pipelined update, which
        returns the next lane in the state."""
        cfg = self.cfg
        plan = self.engine.plan_for(stage)
        use_k = self.gf_cfg.use_kernels
        guarded = self.gf_cfg.guarded
        staged = self.gf_cfg.overlap == "staged"

        def body(state: TrainState, batch: Dict[str, torch.Tensor], lr,
                 step):
            params, opt = state.params, state.opt
            if pipelined:
                with torch.no_grad():
                    params, opt = self.engine.apply_inflight(
                        plan, params, opt, state.inflight)
            leaves = [p.detach().requires_grad_(True)
                      for p in self.pool.flat_leaves(params)]
            tracked = self.pool.unflatten(leaves)
            cp = _tree_map(lambda p: p.to(self.compute_dtype), tracked)
            loss, metrics = self.model.loss_fn(
                cp, batch, remat=cfg.remat, attn_chunk=cfg.attn_chunk,
                compute_dtype=self.compute_dtype)
            if guarded:
                # Every gradient carries the live scale (small ones survive
                # the wire cast); the logged loss stays unscaled.
                loss = loss * state.guard.scale
            grads = torch.autograd.grad(loss, leaves)
            del cp, tracked, leaves, loss
            gpool, census, staging = self.pool.pack_into(
                state.staging, self.pool.unflatten(list(grads)),
                dtype=self._pack_dtype, norms_chunk=self._census_chunk,
                use_kernels=use_k)
            del grads
            if fault_hook is not None:
                gpool = fault_hook(gpool, step)
                census = None  # it describes the pool before the fault
            scaler, flags, lane = state.guard, None, ()
            with torch.no_grad():
                if pipelined and guarded:
                    params, opt, gf, scaler, lane, flags = \
                        self.engine.run_pipelined_guarded(
                            plan, gpool, params, opt, state.gf, state.guard,
                            lr)
                elif pipelined:
                    params, opt, gf, lane = self.engine.run_pipelined(
                        plan, gpool, params, opt, state.gf, lr)
                elif guarded and staged:
                    params, opt, gf, scaler, flags = self.engine.run_guarded(
                        plan, gpool, params, opt, state.gf, state.guard, lr,
                        census=census)
                elif guarded:
                    params, opt, gf, scaler, flags = \
                        self._monolithic_update_guarded(
                            stage, gpool, params, opt, state.gf, state.guard,
                            lr, census)
                elif staged:
                    params, opt, gf = self.engine.run(
                        plan, gpool, params, opt, state.gf, lr,
                        census=census)
                else:
                    params, opt, gf = self._monolithic_update(
                        stage, gpool, params, opt, state.gf, lr, census)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if flags is not None:
                metrics.update(guard_mod.as_metrics(flags))
            return TrainState(params=params, opt=opt, gf=gf,
                              step=state.step + 1, guard=scaler,
                              staging=staging, inflight=lane), metrics

        return body

    def _monolithic_update(self, stage, gpool, params, opt, gfstate, lr,
                           census=None):
        """``overlap='monolithic'``: reduce every bucket
        (``GradientFlow.reduce``, with the pack's census on the low-bit
        dense and lazy wires), pack the f32 masters, LARS's ratios over
        the whole pool, then one fused update + unpack of the whole pool
        (one ``pool_unpack_update`` launch with ``use_kernels``), written
        into the parameters and the optimizer state in place."""
        cfg = self.gf_cfg
        use_k = cfg.use_kernels
        reduced, mask, gf2 = self.gf.reduce(
            gpool, gfstate, stage=stage,
            prepacked=not (cfg.csc_enabled or cfg.quantized), census=census)
        master, _ = self.pool.pack(params, dtype=torch.float32,
                                   use_kernels=use_k)
        scale = ratios = None
        if self.lars is not None:
            # Outside CSC the mask is all true: the norms need no masking.
            ratios = self.lars.ratios(master, reduced, self.cfg.optimizer,
                                      mask if cfg.csc_enabled else None)
            if not use_k:
                scale, ratios = self.lars.expand(ratios), None
        new_params, opt2 = optim.update_unpack(
            self.opt_name, self.pool, master, reduced, opt, mask,
            self.cfg.optimizer, lr, scale=scale, ratios=ratios,
            use_kernels=use_k, out_leaves=self.pool.flat_leaves(params))
        return new_params, opt2, gf2


    def _monolithic_update_guarded(self, stage, gpool, params, opt, gfstate,
                                   scaler, lr, census=None):
        """``overlap='monolithic'`` under the guard (the JAX package's
        ``_inner_update_guarded``): ``gpool`` arrives scaled. Native dense
        and lazy reduce the scaled wire pool and take the verdict from the
        reduced pool's health word, then unscale the mean. The low-bit
        dense and lazy wires sum the census first (the pack's, or taken
        here) and pass the sum into ``reduce`` with the scale, so the
        step issues the unguarded step's collectives; the verdict reads
        the census sum (the clip hides poison from the words). CSC
        unscales the f32 pool first and takes the verdict from the summed
        census ``reduce`` already computes, on a low-bit sparse stage
        against the per-chunk limit. Then the master pack, LARS's ratios
        (NaN on a tripped step, which the skipped launch never reads) and
        one update behind ``ok``; the state ``reduce`` returned (CSC's
        ``hg`` and census, the residual) is committed with
        ``commit_where``. Returns (params, opt, gfstate, new scaler state,
        HealthFlags)."""
        cfg = self.gf_cfg
        use_k = cfg.use_kernels
        quantized = cfg.quantized
        limit = guard_mod.overflow_limit(cfg.guard, cfg.wire_dtype)
        loss_scale = scaler.scale if quantized else None
        if cfg.csc_enabled:
            reduced, mask, gf2 = self.gf.reduce(gpool.div_(scaler.scale),
                                                gfstate, stage=stage,
                                                loss_scale=loss_scale)
            limit_c = limit
            if quantized and stage.num_selected < self.gf.num_chunks:
                limit_c = guard_mod.per_chunk_limit(gfstate.chunk_norms,
                                                    cfg.guard, limit)
            flags = guard_mod.flags_from_census(gf2.chunk_norms, limit_c)
        elif quantized:
            if census is None:
                census = wire_chunk_l1(gpool, cfg.chunk_elems)
            census_sum = collectives.reduce_pool(census)
            reduced, mask, gf2 = self.gf.reduce(gpool, gfstate, stage=stage,
                                                census_sum=census_sum,
                                                loss_scale=loss_scale)
            flags = guard_mod.flags_from_census(census_sum, limit)
            reduced.div_(scaler.scale)
        else:
            reduced, mask, gf2 = self.gf.reduce(gpool, gfstate, stage=stage,
                                                prepacked=True)
            flags = guard_mod.flags_from_words(
                [guard_mod.health_word(reduced)], limit)
            reduced.div_(scaler.scale)
        ok = ~guard_mod.tripped(flags)
        master, _ = self.pool.pack(params, dtype=torch.float32,
                                   use_kernels=use_k)
        scale = ratios = None
        if self.lars is not None:
            ratios = self.lars.ratios(master, reduced, self.cfg.optimizer,
                                      mask if cfg.csc_enabled else None)
            if not use_k:
                scale, ratios = self.lars.expand(ratios), None
        new_params, opt2 = optim.update_unpack(
            self.opt_name, self.pool, master, reduced, opt, mask,
            self.cfg.optimizer, lr, scale=scale, ratios=ratios,
            use_kernels=use_k, out_leaves=self.pool.flat_leaves(params),
            ok=ok)
        new, old = [], []
        if cfg.csc_enabled:
            new += [gf2.hg, gf2.chunk_norms]
            old += [gfstate.hg, gfstate.chunk_norms]
        if cfg.feedback_enabled:
            new.append(gf2.residual)
            old.append(gfstate.residual)
        if new:
            guard_mod.commit_where(ok, new, old)
        return (new_params, opt2, gfstate,
                scaler_mod.update(scaler, ok, cfg.guard), flags)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

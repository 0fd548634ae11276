"""The training step: model + GradientFlow + optimizer, in PyTorch.

One step, as ``repro/launch/trainer.py`` runs it with the flat collective:

1. forward and backward on the f32 masters cast to ``compute_dtype``
   (explicit ``.to``, not autocast), so the gradients come back in f32;
2. ``GradientPool.pack_into`` writes them into the pool, in the staging
   buffer the previous step handed back (``TrainState.staging``): in the
   wire dtype for dense and lazy, in f32 for CSC, whose pool is padded to
   a chunk multiple;
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
reduce (``runtime.faults``). Gradient accumulation is not ported yet.
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
        collectives.level_groups(gf_cfg.topology)
        # CSC chunks the pool: pad it to a chunk multiple.
        pad = gf_cfg.chunk_elems if gf_cfg.csc_enabled else 1
        self.pool = GradientPool(self.model.param_shapes(), pad_to=pad)
        self.gf = GradientFlow(gf_cfg, self.pool, self.num_data)
        self.gf_cfg = gf_cfg
        # 'auto' resolves to the flat ring on one level (resolve_algorithm).
        if gf_cfg.collective_algo == "pallas_ring" or (
                gf_cfg.collective_algo == "auto"
                and len(gf_cfg.topology.levels) > 1):
            kops.ring_prepare(collectives.ring_levels(gf_cfg.topology),
                              self.device)
        self.opt_name = cfg.optimizer.name
        self.lars = LARSScaler(self.pool) if self.opt_name == "lars" \
            else None
        self.engine = OverlapEngine(self.gf, self.opt_name, cfg.optimizer,
                                    lars=self.lars)
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)

    @property
    def _pack_dtype(self) -> torch.dtype:
        """Dense/lazy pack the gradients straight to the wire dtype; CSC
        packs to f32, because hg is added before the wire cast."""
        if self.gf_cfg.csc_enabled:
            return torch.float32
        return wire_dtype_of(self.gf_cfg)

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
        ``step`` is the host int ``state.step``."""
        cfg = self.cfg
        plan = self.engine.plan_for(stage)
        use_k = self.gf_cfg.use_kernels
        guarded = self.gf_cfg.guarded

        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in batch.items()}
            leaves = [p.detach().requires_grad_(True)
                      for p in self.pool.flat_leaves(state.params)]
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
            gpool, _, staging = self.pool.pack_into(
                state.staging, self.pool.unflatten(list(grads)),
                dtype=self._pack_dtype, use_kernels=use_k)
            del grads
            if fault_hook is not None:
                gpool = fault_hook(gpool, state.step)
            lr = lr_at(cfg.optimizer, state.step)
            if self.device.type == "cuda":
                lr = lr.pin_memory().to(self.device, non_blocking=True)
            scaler, flags = state.guard, None
            with torch.no_grad():
                if guarded and self.gf_cfg.overlap == "staged":
                    params, opt, gf, scaler, flags = self.engine.run_guarded(
                        plan, gpool, state.params, state.opt, state.gf,
                        state.guard, lr)
                elif guarded:
                    params, opt, gf, scaler, flags = \
                        self._monolithic_update_guarded(
                            stage, gpool, state.params, state.opt, state.gf,
                            state.guard, lr)
                elif self.gf_cfg.overlap == "staged":
                    params, opt, gf = self.engine.run(
                        plan, gpool, state.params, state.opt, state.gf, lr)
                else:
                    params, opt, gf = self._monolithic_update(
                        stage, gpool, state.params, state.opt, state.gf, lr)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if self.num_data > 1:
                for v in metrics.values():
                    collectives.all_reduce_sum(v)
                    v.div_(self.num_data)
            if flags is not None:
                # The same on every rank already: no collective.
                metrics.update(guard_mod.as_metrics(flags))
            return TrainState(params=params, opt=opt, gf=gf,
                              step=state.step + 1, guard=scaler,
                              staging=staging), metrics

        return step

    def _monolithic_update(self, stage, gpool, params, opt, gfstate, lr):
        """``overlap='monolithic'``: reduce every bucket
        (``GradientFlow.reduce``), pack the f32 masters, LARS's ratios over
        the whole pool, then one fused update + unpack of the whole pool
        (one ``pool_unpack_update`` launch with ``use_kernels``), written
        into the parameters and the optimizer state in place."""
        cfg = self.gf_cfg
        use_k = cfg.use_kernels
        reduced, mask, gf2 = self.gf.reduce(
            gpool, gfstate, stage=stage, prepacked=not cfg.csc_enabled)
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
                                   scaler, lr):
        """``overlap='monolithic'`` under the guard (the JAX package's
        ``_inner_update_guarded``, native wires): ``gpool`` arrives scaled.
        Dense and lazy reduce the scaled wire pool and take the verdict
        from the reduced pool's health word, then unscale the mean; CSC
        unscales the f32 pool first and takes the verdict from the summed
        census ``reduce`` already computes. Then the master pack, LARS's
        ratios (NaN on a tripped step, which the skipped launch never
        reads) and one update behind ``ok``; CSC's new ``hg`` and census
        are committed with ``commit_where``. Returns (params, opt,
        gfstate, new scaler state, HealthFlags)."""
        cfg = self.gf_cfg
        use_k = cfg.use_kernels
        limit = guard_mod.overflow_limit(cfg.guard, cfg.wire_dtype)
        if cfg.csc_enabled:
            reduced, mask, gf2 = self.gf.reduce(gpool.div_(scaler.scale),
                                                gfstate, stage=stage)
            flags = guard_mod.flags_from_census(gf2.chunk_norms, limit)
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
        if cfg.csc_enabled:
            guard_mod.commit_where(ok, (gf2.hg, gf2.chunk_norms),
                                   (gfstate.hg, gfstate.chunk_norms))
        return (new_params, opt2, gfstate,
                scaler_mod.update(scaler, ok, cfg.guard), flags)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

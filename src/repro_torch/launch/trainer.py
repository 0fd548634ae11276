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
own batch shard to ``step``); with none, the step is one shard's. The
guard and gradient accumulation are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Union

import dataclasses

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core.engine import OverlapEngine
from repro_torch.core.gradientflow import GFState, GradientFlow, wire_dtype_of
from repro_torch.core.pool import GradientPool
from repro_torch.core.schedule import SparsityStage
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.optim import lr_at
from repro_torch.optim.lars import LARSScaler
from repro_torch.parallel import collectives
from repro_torch.parallel.topology import mesh_topology

_ROADMAP = "is not ported to repro_torch yet; see ROADMAP.md queue A"


class TrainState(NamedTuple):
    params: Any          # nested dict of f32 master tensors
    opt: Any             # SGDState or AdamWState, pool-shaped tensors
    gf: GFState          # CSC: this rank's hg row and the chunk norms
    step: int
    staging: Any = None  # the pool buffer the next pack writes into


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 device: Optional[Union[str, torch.device]] = None):
        gf_cfg = cfg.gradientflow
        if gf_cfg.guarded:
            raise NotImplementedError("the numeric guard " + _ROADMAP)
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
        state (SGD's momentum; AdamW's moments and counts), zero staging
        buffer."""
        if params is None:
            params = self.model.init_params(seed, self.device)
        else:
            self.pool.flat_leaves(params)  # shape check
        return TrainState(
            params=params,
            opt=optim.init_state(self.opt_name, self.pool.size, self.device),
            gf=self.gf.init_state(self.device), step=0,
            staging=torch.zeros((self.pool.size,), dtype=self._pack_dtype,
                                device=self.device))

    def build_train_step(self, stage: Optional[SparsityStage] = None):
        """``step(state, batch) -> (state, metrics)`` under CSC stage
        ``stage`` (default: the steady one; dense and lazy have one).
        ``batch`` is this rank's {'tokens', 'labels'} (any device; moved to
        the trainer's). The returned state shares the parameter,
        optimizer-state and staging tensors of the one passed in (and,
        staged, CSC's hg), which are updated in place."""
        cfg = self.cfg
        plan = self.engine.plan_for(stage)
        use_k = self.gf_cfg.use_kernels

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
            grads = torch.autograd.grad(loss, leaves)
            del cp, tracked, leaves, loss
            gpool, _, staging = self.pool.pack_into(
                state.staging, self.pool.unflatten(list(grads)),
                dtype=self._pack_dtype, use_kernels=use_k)
            del grads
            lr = lr_at(cfg.optimizer, state.step)
            if self.device.type == "cuda":
                lr = lr.pin_memory().to(self.device, non_blocking=True)
            with torch.no_grad():
                if self.gf_cfg.overlap == "staged":
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
            return TrainState(params=params, opt=opt, gf=gf,
                              step=state.step + 1,
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


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

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

The data-parallel topology comes from the data degree (one ``('data', N)``
level) unless the config names one covering the same ranks; its level
groups, and on the card the ring workspace of each level group that a
``pallas_ring`` bucket may run over, are created when the trainer is.

CSC's step depends on its warm-up stage: ``build_train_step(stage)``
builds one step function per stage, and the caller picks the stage of
each step with ``gf.stage_for_step``. With ``use_kernels`` the packs, the
updates of SGD and LARS and CSC's gather and census go through
``kernels.ops``: the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors. The data-parallel group is the default
``torch.distributed`` group when one is initialised, or a mesh's data
group (each rank passes its own batch shard to ``step``); with none, the
step is one shard's.

With ``GradientFlowConfig.guard`` (the numeric guard rail, ``core.guard``)
the loss is multiplied by the live loss scale (``TrainState.guard``, an
``optim.scaler.ScalerState``) before the backward pass, the step issues
exactly the unguarded step's collectives, its verdict is a device flag
(the ``guard_tripped`` metric), and a tripped step leaves parameters,
optimizer state and CSC's state bit-identical; only the scaler advances.
``build_train_step(fault_hook=...)`` corrupts the packed pool before the
reduce (``runtime.faults``); the hook writes after the pack's census, so
a low-bit dense or lazy step then takes the census anew from the pool it
corrupted.

With ``TrainConfig.microbatches`` n > 1 the step accumulates gradients,
as the JAX package's ``_accumulate`` does: n contiguous slices of the
batch's rows, one forward and backward each in order, the f32 gradients
summed into zeros and divided by n, each metric the sum of its value / n
(guarded: each slice's loss carries the live scale). The pack, the
reduce and the update then run once, in every mode, guard, wire and
overlap, in a window too.

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

A step runs in a ``launch.call`` span and leaves a call record
(``runtime.trace``); each microbatch's forward and backward run in
``model.forward`` and ``model.backward``.

``Trainer(cfg, device, mesh)`` with a ('data', 'model') or ('pod',
'data', 'model') mesh (``launch.mesh.make_mesh``) whose model axis has
M > 1 ranks trains
every family sharded over it, as the JAX Trainer does on such a mesh:
the architecture's rule table (``configs.rules_for``) shards each weight
(``parallel.sharding``); each rank holds its blocks, runs the model's
sharded forward and backward (Megatron's attention and MLPs, expert- or
expert-tensor-parallel MoE, channel-parallel Mamba blocks,
vocab-parallel embeddings and heads: ``parallel.model_axis``, over the
mesh's model group) and keeps a local gradient pool over its own blocks
(``sharding.localize_specs``), reduced over its data group only; the
optimizer steps its local pool. ``global_pool`` and
``num_chunks_global`` are the JAX Trainer's. The update after the data
reduce is the JAX update region's on each rank's local pool: dense, lazy
and CSC, staged or monolithic, momentum SGD, LARS (trust ratios over the
local spans: a sharded leaf's block has its own ratio, as in JAX) or
AdamW, an f32, bf16 or float16 wire or the int8 and fp8-e4m3 wires with
or without error feedback (scales from the rank's data-summed census,
the residual on the local pool), microbatches, with or without the guard
and kernels, eager steps or windows. The data reduce takes every
collective algorithm (flat, ``pallas_ring``, ``tree``, ``two_level``,
``auto``) over the topology of the mesh's data axes (one level, or
('pod', 'data')'s two), each level group inside the rank's data group
(``parallel.collectives.level_groups``). ``checkpoint_layout`` tells a
``checkpoint.CheckpointManager`` how the rank's blocks sit in JAX's
global arrays. Two things read the model group besides the model's own
sums: CSC selects on the group's summed chunk norms, and the guard's
verdict is the group's max of the flags, so the ranks of a model group
select the same chunks and commit or skip together (both depart from
JAX, which decides each on the rank's own pool; ROADMAP.md C). A replan
to another model degree raises, naming ROADMAP.md A.23, as the JAX
Trainer refuses it.

Serving (``build_serve_step``) returns the JAX Trainer's serving rules
(``serve_rules``: the cache's batch on the data axes, its positions on
'model' where the rules leave the KV heads replicated) and, under M > 1,
runs every family sharded as the rules say: each rank serves its data
rank's rows (``serve_rows``) on its serving weights (``serve_local``,
made once: no serve step gathers a weight) against its blocks of the
cache (``abstract_serve_args``, ``init_serve_cache``; the layers'
``cache_logical_axes``): a rank's KV heads, or every KV head at its
block of positions with a decode's online-softmax partials combined over
the model group (no cache is gathered, ``flash_decode`` or not), the
Mamba states on the rank's channels or heads; the logits come back whole
on every rank.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

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
from repro_torch.models import params as params_mod
from repro_torch.optim import lr_at
from repro_torch.optim import scaler as scaler_mod
from repro_torch.optim.lars import LARSScaler
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.model_axis import ModelAxis
from repro_torch.parallel.topology import mesh_topology
from repro_torch.runtime import trace

_A23 = ("is refused, as the JAX Trainer refuses it: an elastic event keeps "
        "the model degree (ROADMAP.md A.23)")


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


def refuse_model_axis(cfg: TrainConfig, model_size: int,
                      rules: Dict[str, Optional[str]]) -> None:
    """Raise for heads that the rule table ``rules`` splits but that do
    not split over ``model_size`` > 1 model ranks."""
    m = cfg.model

    def split(axis):
        return rules.get(axis) == "model"

    # The query heads split when the rules shard the projections or the
    # heads; the KV heads only when 'kv_heads' is sharded (otherwise a
    # rank gathers them, attention.apply_train). The ssm family has no
    # attention.
    heads_split = m.family != "ssm" and (split("heads") or split("qkv"))
    if (heads_split and m.num_heads % model_size) or (
            heads_split and split("kv_heads")
            and m.num_kv_heads % model_size):
        raise ValueError(
            f"{m.num_heads} query and {m.num_kv_heads} KV heads do not "
            f"split over {model_size} model ranks as the rules shard them: "
            f"each rank's query heads must be whole, and with 'kv_heads' "
            f"sharded map onto its own KV heads")
    if m.family == "hybrid" and split("dinner"):
        from repro_torch.models.layers import mamba2
        heads = mamba2.dims(m)[1]
        if heads % model_size:
            raise ValueError(f"{heads} Mamba-2 heads do not split over "
                             f"{model_size} model ranks")


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        gf_cfg = cfg.gradientflow
        if gf_cfg.overlap not in ("staged", "monolithic"):
            raise ValueError(f"unknown overlap {gf_cfg.overlap!r}")
        if cfg.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got "
                             f"{cfg.microbatches}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model)
        self.specs = self.model.param_specs()
        self.mesh = mesh
        self.model_size = mesh.model_size if mesh is not None else 1
        self.data_axes = mesh.data_axes if mesh is not None else ("data",)
        self.rules = None
        self.model_axis = None
        self.local_specs = self.specs
        if self.model_size > 1:
            from repro_torch.configs import rules_for
            self.rules = rules_for(cfg.model)
            refuse_model_axis(cfg, self.model_size, self.rules)
            self.model_axis = ModelAxis(mesh.model_group.group,
                                        self.model_size, mesh.model_index,
                                        self.rules)
            self.local_specs = sharding.localize_specs(
                self.specs, self.rules, self.model_size)
        self.num_data = mesh.num_data if mesh is not None \
            else collectives.data_world_size()
        gf_cfg = dataclasses.replace(gf_cfg, topology=mesh_topology(
            self.num_data, gf_cfg.topology, self._data_shape()))
        self._prepare_groups(gf_cfg)
        # CSC chunking and the low-bit wires' per-chunk scales both key
        # off whole chunks: pad the pool to a chunk multiple for either.
        pad = gf_cfg.chunk_elems \
            if (gf_cfg.csc_enabled or gf_cfg.quantized) else 1
        self.pool = GradientPool(params_mod.param_shapes(self.local_specs),
                                 pad_to=pad)
        if self.model_axis is not None:
            self._check_pool_layout()
        self.gf = GradientFlow(gf_cfg, self.pool, self.num_data,
                               model_axis=self.model_axis)
        # The model-sharded totals, as the JAX Trainer keeps them.
        self.global_pool = self.pool.size * self.model_size
        self.num_chunks_global = self.gf.num_chunks * self.model_size
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

    def _check_pool_layout(self) -> None:
        """Under a model axis CSC's ranks select the same chunk ids on
        their own local pools, which are the same elements only if every
        rank's pool has the same segment table (``localize_specs``: even
        blocks, the leaves in one order). Compare the offsets, sizes and
        padded size across the model group once (two all-reduces, the
        table's max and its negation's; a group without a process group
        behind it, as a test's stand-in mesh, has nothing to compare)."""
        if not torch.distributed.is_initialized():
            return
        table = torch.tensor(list(self.pool.offsets) + list(self.pool.sizes)
                             + [self.pool.size], dtype=torch.int64,
                             device=self.device)
        hi = self.model_axis.max_(table.clone())
        lo = self.model_axis.max_(-table)
        if not (torch.equal(hi, table) and torch.equal(-lo, table)):
            raise ValueError("the model ranks' local pools have different "
                             "segment tables: CSC's shared selection needs "
                             "them equal")

    def _data_shape(self) -> Optional[Tuple[int, ...]]:
        """The sizes of the mesh's data axes (None without a mesh)."""
        return self.mesh.data_shape if self.mesh is not None else None

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

    def replan(self, topology=None, mesh=None) -> None:
        """Re-resolve the collective layer for a new topology over the
        same ranks (an elastic event): the data degree from the world
        size and ``topology`` (``mesh_topology``: one ('data', N) level
        when None), its level groups (``dist.new_group``: every rank
        calls this, in one order) and ring workspaces, then
        ``OverlapEngine.replan`` (θ re-tuned, algorithms re-selected, the
        plan cache cleared). Steps and windows built before hold the old
        plan and refuse to run: release the windows and build new ones.
        A new world size is a relaunch (``checkpoint.reshard``). ``mesh``
        (default: the trainer's) must keep the model degree: an elastic
        event changes only the data degree (another model degree is
        refused, as the JAX Trainer asserts it away; ROADMAP.md A.23);
        its data axes give the default topology."""
        if mesh is not None:
            if mesh.model_size != self.model_size:
                raise ValueError(f"a replan from model degree "
                                 f"{self.model_size} to {mesh.model_size} "
                                 f"{_A23}")
            self.mesh, self.data_axes = mesh, mesh.data_axes
        self.num_data = self.mesh.num_data if self.mesh is not None \
            else collectives.data_world_size()
        topo = mesh_topology(self.num_data, topology, self._data_shape())
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
            if self.model_size > 1:
                params = self.shard_params(params)
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

    def shard_params(self, full: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's blocks of a full f32 parameter tree (tensors), as
        contiguous tensors of their own on the trainer's device; the tree
        itself under no model axis."""
        if self.model_size == 1:
            return full
        local = sharding.shard_tree(full, self.specs, self.rules,
                                    self.model_size, self.mesh.model_index)
        return _tree_map(lambda x: x.to(self.device).contiguous().clone(),
                         local)

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
            with trace.call(1):
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
        pipeline, its lane on the local pool under a model axis. On the
        card a step that would sum through a gloo group (the model group's
        sums among them) raises here
        (``launch.window.host_collectives``)."""
        from repro_torch.launch.window import TrainWindow

        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        plan = self._pipeline_plan(stage) if window_steps > 1 else None
        body = self._step_body(stage, fault_hook, pipelined=plan is not None)
        return TrainWindow(self, window_steps, body, plan,
                           self.engine.plan_for(stage))

    def checkpoint_layout(self):
        """How this rank's state sits in the JAX Trainer's global arrays
        (``checkpoint.manager.ModelLayout``), for a ``CheckpointManager``
        under a model axis; None without one (the state is global)."""
        if self.model_size == 1:
            return None
        from repro_torch.checkpoint.manager import ModelLayout
        from repro_torch.core.pool import flatten_tree
        dims = {"params/" + "/".join(path): sharding.model_dim(s, self.rules)
                for path, s in flatten_tree(self.specs)}
        return ModelLayout(model_size=self.model_size,
                           model_index=self.mesh.model_index,
                           num_data=self.num_data,
                           data_index=self.mesh.data_index,
                           model_group=self.mesh.model_group.group,
                           param_dims=dims)

    # -- serving ------------------------------------------------------------

    def _arch_rules(self) -> Dict[str, Optional[str]]:
        """The architecture's rule table (under no model axis too: JAX's
        serving returns the rules on any mesh)."""
        if self.rules is not None:
            return self.rules
        from repro_torch.configs import rules_for
        return rules_for(self.cfg.model)

    def _mesh_sizes(self) -> Dict[str, int]:
        """Each mesh axis's size: the mesh's, or ('data', 'model') =
        (the data degree, 1) without one."""
        if self.mesh is not None:
            return dict(zip(self.mesh.axis_names, self.mesh.shape))
        return {"data": self.num_data, "model": 1}

    def serve_rules(self, long_context: bool = False
                    ) -> Dict[str, Any]:
        """The serving rules, as the JAX Trainer writes them: the cache's
        batch ('serve_batch') on the data axes; its positions ('kv_seq')
        on 'model' when the rules leave the KV heads replicated under a
        model axis; in long context (a batch below the data degree) the
        batch not split."""
        r: Dict[str, Any] = dict(self._arch_rules())
        r["serve_batch"] = tuple(self.data_axes) if self.data_axes else None
        if r.get("kv_heads") is None and self.model_size > 1:
            r["kv_seq"] = "model"
        if long_context:
            r["serve_batch"] = None
        return r

    def serve_step_rules(self, shape, *, mode: str,
                         kv_seq_shard: Optional[Any] = None,
                         flash_decode: bool = False) -> Dict[str, Any]:
        """``build_serve_step``'s rules: ``serve_rules`` (long context when
        ``shape.global_batch`` is below the data degree), ``kv_seq_shard``
        in place of the cache's sequence rule, and ``flash_decode``'s
        replicated 'heads' for a decode against a sequence-split cache
        (the JAX Trainer's returned rules)."""
        rules = self.serve_rules(
            long_context=shape.global_batch < self.num_data)
        if kv_seq_shard is not None:
            rules["kv_seq"] = kv_seq_shard
        if flash_decode and mode == "decode" and \
                rules.get("kv_seq") == "model":
            rules["heads"] = None
        return rules

    def _serve_axis(self, rules: Dict[str, Any]) -> Optional[ModelAxis]:
        """The model axis a serve step runs under (its rules the serve
        rules), after refusing rules it has no form for; None without a
        model axis."""
        if self.model_size == 1:
            return None
        if rules.get("kv_seq") not in (None, "model"):
            raise ValueError(
                f"kv_seq={rules['kv_seq']!r}: the port splits a cache's "
                f"positions over the model axis only (ROADMAP.md C)")
        axis = ModelAxis(self.mesh.model_group.group, self.model_size,
                         self.mesh.model_index, rules)
        fam = self.cfg.model.family
        if fam != "ssm":
            from repro_torch.models.layers import attention
            attention.serve_layout(axis)
        if fam == "hybrid" and axis.sharded("dinner") \
                != axis.sharded("heads"):
            raise ValueError(
                "the hybrid's Mamba-2 decode runs a rank's heads: its "
                "rules must shard 'heads' with 'dinner' (flash_decode's "
                "replicated heads have no Mamba-2 form)")
        return axis

    def build_serve_step(self, shape, *, mode: str,
                         kv_seq_shard: Optional[Any] = None,
                         split_combine: bool = False,
                         flash_decode: bool = False):
        """``(step, rules)``: ``step(params, batch, cache) -> (logits,
        cache)`` runs ``model.serve_step`` in ``mode`` ('prefill' or
        'decode') under ``torch.no_grad`` at the model's compute dtype,
        the batch moved to the trainer's device; ``rules`` are the JAX
        Trainer's serving rules (``serve_step_rules``). ``params`` are
        the serving weights (the CLI's are bf16); the cache is consumed:
        the returned one shares its tensors, updated in place. No
        training state is allocated.

        Under a model axis ``params`` are the rank's ``serve_local``
        weights, ``batch`` its data rank's rows (``serve_rows``) and
        ``cache`` its blocks under ``rules`` (``init_serve_cache``,
        ``convert.shard_cache``); the logits come back whole on every
        rank. The step gathers no weight and no cache: a cache split by
        position is read where it lies, each rank's online-softmax
        partials combined over the model group (``attention``'s 'seq'
        form), with or without ``flash_decode``, whose rules replicate
        the heads as JAX's do (JAX's naive GSPMD form all-gathers the
        cache instead; ROADMAP.md C). ``step.model_axis`` is the axis
        the step runs under (``runtime.trace``'s ``model_axis`` group
        counts the model group's all-reduces;
        ``expected_serve_all_reduces`` gives their number),
        None without one."""
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown serve mode {mode!r}")
        rules = self.serve_step_rules(shape, mode=mode,
                                      kv_seq_shard=kv_seq_shard,
                                      flash_decode=flash_decode)
        axis = self._serve_axis(rules)
        # A batch or cache dimension that does not split whole over its
        # mesh axes is refused here, named by its logical axis.
        self.abstract_serve_args(shape, rules, mode)
        model, dtype, dev = self.model, self.compute_dtype, self.device

        def step(params, batch: Dict[str, torch.Tensor], cache):
            batch = {k: v.to(dev, non_blocking=True)
                     for k, v in batch.items()}
            return model.serve_step(params, batch, cache, mode=mode,
                                    compute_dtype=dtype,
                                    split_combine=split_combine,
                                    model_axis=axis)

        step.model_axis = axis
        return step, rules

    def serve_local(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The serving weights of this rank from its blocks ``params``
        (``shard_params``' tree, in the serving dtype): made once, before
        the steps, so that no serve step gathers a weight (the Mamba
        blocks' fused projections and conv are gathered here, one
        all-reduce a stacked leaf; every other leaf is its block). The
        tree itself under no model axis."""
        if self.model_size == 1:
            return params
        return self.model.serve_local(params, self.model_axis)

    def _serve_max_len(self, shape) -> int:
        """The cache's positions: the shape's length, and a vlm's vision
        tokens on top (its prefill writes them first)."""
        m = self.cfg.model
        return shape.seq_len + (m.num_vision_tokens
                                if m.family == "vlm" else 0)

    def abstract_serve_args(self, shape, rules: Dict[str, Any], mode: str,
                            cache_dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[Any, Any, Any]:
        """(params, batch, cache) as this rank's local (shape, dtype)
        pairs, each the JAX Trainer's ``NamedSharding.shard_shape`` of
        the leaf in its ``abstract_serve_args``: the bf16 parameter
        blocks (the rules' model dimensions split), the batch's rows
        split over the data degree when it covers it (JAX's
        ``batch_pspec``), the cache of ``shape.seq_len`` positions (a
        vlm's vision tokens added) split under ``rules``. A dimension
        that does not split whole is refused by its logical axis."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.models.registry import input_specs
        b = shape.global_batch
        m = self.model_size
        params = params_mod.map_specs(
            lambda sp: (sp.shape, torch.bfloat16),
            sharding.localize_specs(self.specs, self._arch_rules(), m))
        n = self.num_data
        rows = b // n if b >= n and b % n == 0 else b
        batch = input_specs(self.cfg.model, ShapeConfig(
            name=shape.name, seq_len=shape.seq_len, global_batch=b,
            kind=mode), rows)
        sizes = self._mesh_sizes()
        cache = sharding.map_axes(
            lambda ax, leaf: (sharding.local_shape(leaf[0], ax, rules,
                                                   sizes), leaf[1]),
            self.model.cache_logical_axes(),
            self.model.abstract_cache(b, self._serve_max_len(shape),
                                      cache_dtype))
        return params, batch, cache

    def init_serve_cache(self, shape, rules: Dict[str, Any],
                         dtype: torch.dtype = torch.bfloat16) -> Any:
        """This rank's empty cache blocks (zeros) under ``rules`` on the
        trainer's device: ``abstract_serve_args``' cache."""
        return params_mod.zeros_of(
            self.abstract_serve_args(shape, rules, "decode", dtype)[2],
            self.device)

    def serve_rows(self, global_batch: int) -> slice:
        """The rows of a global serving batch that this rank serves: its
        data rank's block when the batch covers the data degree, every
        row in long context (JAX's ``batch_pspec``)."""
        n = self.num_data
        if global_batch >= n and global_batch % n == 0 and n > 1:
            k = global_batch // n
            i = self.mesh.data_index if self.mesh is not None \
                else torch.distributed.get_rank()
            return slice(i * k, (i + 1) * k)
        return slice(0, global_batch)

    def expected_serve_all_reduces(self, mode: str,
                                   rules: Dict[str, Any]) -> int:
        """The model group's all-reduces of one serve step in ``mode``
        under ``rules``, counted from the code: the vocab-parallel
        embedding's sum and the logits' gather; a layer's attention by
        its cache form (``attention.serve_layout``: 'heads' the
        row-parallel output sum; 'seq' with sharded projections the k
        and v gather and the output sum in a prefill, the joined q, k
        and v, the partials' combine and the output sum in a decode;
        'seq' replicated the combine of a decode), its MLP's output sum
        or its MoE's combine (one with arctic's residual, or one each
        when only one of them is split); Mamba-1 the Δ/B/C sum and the
        output sum; Mamba-2 the gated norm's sum and the output sum,
        and in a decode the window's join. No weight is gathered."""
        if self.model_size == 1:
            return 0
        from repro_torch.models.layers import attention
        cfg = self.cfg.model
        axis = ModelAxis(None, self.model_size, 0, rules)
        sh = axis.sharded
        n = 2 if sh("vocab") else 0

        def attn():
            layout = attention.serve_layout(axis)
            if layout == "heads":
                return 1
            if layout == "seq" and sh("qkv"):
                return 2 if mode == "prefill" else 3
            return int(layout == "seq" and mode == "decode")

        def ffn():
            if cfg.moe is None:
                return int(sh("mlp"))
            split = sh("expert") or sh("expert_mlp")
            res = cfg.moe.dense_residual and sh("mlp")
            return 1 if split and res else int(split) + int(res)

        if cfg.family == "ssm":
            return n + cfg.num_layers * (2 if sh("dinner") else 0)
        if cfg.family == "hybrid":
            every = cfg.hybrid_attn_every
            mamba = (2 + (mode == "decode")) if sh("dinner") else 0
            return n + cfg.num_layers * mamba \
                + cfg.num_layers // every * (attn() + int(sh("mlp")))
        return n + cfg.num_layers * (attn() + ffn())

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
            with trace.span("launch.reduce_metrics"):
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
            # Guarded: every gradient carries the live scale (small ones
            # survive the wire cast); the logged loss stays unscaled.
            grads, metrics = self._grads(
                params, batch, state.guard.scale if guarded else None)
            gpool, census, staging = self.pool.pack_into(
                state.staging, self.pool.unflatten(grads),
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
            if flags is not None:
                metrics.update(guard_mod.as_metrics(flags))
            return TrainState(params=params, opt=opt, gf=gf,
                              step=state.step + 1, guard=scaler,
                              staging=staging, inflight=lane), metrics

        return body

    def _grads(self, params, batch: Dict[str, torch.Tensor], scale=None
               ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """(f32 gradient leaves in pool order, metrics) of the loss on this
        rank's ``batch``; ``scale`` (the guard's loss scale) multiplies
        the loss before the backward pass. With ``microbatches`` n > 1:
        the JAX package's ``_accumulate`` (see the module docstring)."""
        n = self.cfg.microbatches
        flat = self.pool.flat_leaves(params)
        if n == 1:
            return self._value_and_grad(flat, batch, scale)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")
        size = rows // n
        # From zeros, not from the first slice's gradient: 0.0 + (-0.0)
        # is +0.0, as in JAX's scan.
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        macc: Dict[str, torch.Tensor] = {}
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            grads, metrics = self._value_and_grad(flat, mb, scale)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            for k, v in metrics.items():
                if k not in macc:
                    macc[k] = torch.zeros((), dtype=torch.float32,
                                          device=v.device)
                macc[k].add_(v / n)
        for a in acc:
            a.div_(n)
        return acc, macc

    def _value_and_grad(self, flat: List[torch.Tensor],
                        batch: Dict[str, torch.Tensor], scale=None
                        ) -> Tuple[List[torch.Tensor],
                                   Dict[str, torch.Tensor]]:
        """One forward and backward on the f32 masters ``flat`` (pool
        order) cast to the compute dtype: (f32 gradients in pool order,
        detached metrics)."""
        cfg = self.cfg
        leaves = [p.detach().requires_grad_(True) for p in flat]
        cp = _tree_map(lambda p: p.to(self.compute_dtype),
                       self.pool.unflatten(leaves))
        tp = {"model_axis": self.model_axis} if self.model_size > 1 else {}
        with trace.span("model.forward"):
            loss, metrics = self.model.loss_fn(
                cp, batch, remat=cfg.remat, attn_chunk=cfg.attn_chunk,
                causal_skip=cfg.causal_skip,
                compute_dtype=self.compute_dtype, **tp)
            if scale is not None:
                loss = loss * scale
        # A leaf the loss does not read (the audio family's unused
        # 'tokens' table) gets zeros, as JAX's gradient gives it.
        with trace.span("model.backward"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))]
        return grads, {k: v.detach() for k, v in metrics.items()}

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
        ``commit_where``. Under a model axis the flags are the model
        group's max (``guard.group_verdict``). Returns (params, opt,
        gfstate, new scaler state, HealthFlags)."""
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
        flags, ok = guard_mod.group_verdict(flags, self.model_axis)
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

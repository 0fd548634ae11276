"""The model axis (tensor parallelism) of the port against the JAX
package's Trainer.

* Four gloo ranks at mesh (2, 2) train olmo-smoke (tied, vocab-parallel
  embedding and head) in f32 compute on an f32 wire, from the JAX
  Trainer's initial weights cut with ``convert.shard_params``:
  - dense and lazy, 4 steps: the losses and the parameters gathered with
    ``convert.unshard_params`` equal JAX's (1, 1) Trainer within 2e-5
    relative (the row-parallel sums and the vocab-parallel log-sum-exp
    add in another order);
  - CSC, 2 dense warm-up steps and 3 sparse ones. The port selects on
    the model group's summed chunk norms (ROADMAP.md C.1), JAX on each
    rank's own, so JAX's own (2, 2) Trainer, on four placeholder devices
    in a subprocess, is the reference up to the first sparse update: the
    parameters after the warm-up, the losses through the first sparse
    step. Each sparse step is then held to the summed selection itself
    (``check_csc_steps``): the ranks of a model group pick the same ids,
    ``repro.core.csc.select_chunks``' on the numpy sum of their norms;
    each data group's reduce equals ``repro.core.csc.csc_reduce`` given
    that basis (its psum over a vmapped data axis), to 1e-6;
  - guarded LARS, lazy, against JAX's (2, 2) Trainer within 2e-5: the
    trust ratios are per shard in both packages (each rank's local
    spans), and nothing trips, so the port's group verdict is JAX's;
  - int8 with error feedback, lazy, against JAX's (2, 2) Trainer: the
    losses within the wire tests' free-running bound, rtol 1e-5
    (``tests/test_torch_wire.py``). An element whose scaled gradient lies
    at a rounding midpoint may round to the neighbouring int8 word in one
    package, and from there its residual and its next steps differ (1-2.4
    % of a leaf's elements after 4 steps, measured), so each leaf's update
    (final minus initial) is held in norm: within 1e-2 of its size (up to
    3.5e-3 measured on the CPU; a gradient missing its model-group sum is
    off by order 1);
  - ``pallas_ring`` (its plain twin over gloo) on CSC's compacted words
    and on int8 words, against the flat modes within 2e-5;
  - the float16 wire against JAX's (2, 2) Trainer: losses within 1e-5,
    parameters within 1e-4 (the half-precision wire bound of
    ``tests/test_torch_trainer.py``);
  - ``build_train_window(3)`` with a 2-bucket deferred tail (the lane on
    each rank's local pool) against JAX's (2, 2) window within 1e-5, and
    bit for bit its own eager steps;
  - checkpoints in JAX's global layout: CSC after its warm-up saved at
    (2, 2) has JAX's manifest (names, shapes, dtypes) and arrays within
    2e-5; JAX's (2, 2) checkpoint of the same run restored in place gives
    JAX's next loss; a lazy checkpoint at (2, 2) restored at (1, 2) goes
    on as the uninterrupted run (JAX's ``test_elastic_reshard_resume``);
  - guarded AdamW, 2 microbatches, monolithic, dense, against JAX's
    (1, 1) Trainer: the losses within 2e-5; each leaf's update within
    1e-3 of its size in norm, and every parameter within 2e-5 relative
    plus 0.1 of a step (the learning rate, 1e-3) absolute. AdamW's update
    m / (sqrt(v) + eps) has unit size whatever the gradient's size, so
    where a gradient changes sign between steps and m nearly cancels,
    the summation order's relative error in the gradients is magnified
    by |g| / |m| in that element's update: up to 0.057 of a step at 1-4
    of 32,768 elements a leaf after 4 steps, 1.2e-4 of an update's norm
    (measured on the CPU).
* Two gloo ranks at mesh (1, 2) train qwen3-smoke (GQA, 8 query and 2
  KV heads, QK-norm, the replicated-KV rule) lazy in bf16 compute: the
  losses within JAX's own bound for the same comparison, rtol 6e-3
  (``tests/test_distributed.py``). The same ranks run a guarded int8
  step with a NaN injected into rank 1's block of a sharded leaf only:
  both ranks trip, keep their parameters, momentum and residual bit for
  bit, halve the same scale, and commit the next step. Then the train
  CLI at ``--mesh 1x2`` (lazy; LARS on the fp8 wire), and with
  ``--ckpt-dir``, windows of 2 and a host fault after step 4: one restart
  from the checkpoint at 4, the fault-free losses bit for bit.
* On every rank the replicated leaves (norm weights, QK-norm scales)
  end bit for bit equal across the model ranks.
* In one process: the collective algorithms, a two-level topology and
  the float16 wire build over the local pool for every family; serving
  and a replan to another model degree raise, naming ROADMAP.md A.23;
  heads that the rules split but that do not split over the model ranks
  raise; without a model axis CSC's selection reads the rank's own
  norms, as before.

The spawns and the two JAX (2, 2) subprocesses start together (``runs``)
and the JAX (1, 1) references are computed while they run. The (2, 2)
ranks wait for JAX's checkpoint file, the (1, 2) ranks for the (2, 2)
ranks' (``wait_for``). JAX's Trainer runs with
``check_vma=False`` on its shard_maps (a test-time patch, as in
``tests/test_torch_accumulate.py``: its ``_accumulate`` fails jax 0.9's
check; nothing in the JAX package changes).
"""
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs import base as t_base
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.models import build_model
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import LevelGroup
from repro_torch.parallel.topology import Topology
from repro_torch.runtime import trace

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
STEPS, B, S = 4, 4, 32
RTOL = 2e-5
# CSC: a dense warm-up stage for steps 0-1, then three sparse steps.
CSC_WARMUP, CSC_STEPS = 2, 5
# mode: (GradientFlowConfig fields, optimizer, microbatches); 'guard'
# True puts the package's GuardConfig() in.
RUNS = {
    "dense": (dict(mode="dense"), "momentum_sgd", 1),
    "lazy": (dict(mode="lazy"), "momentum_sgd", 1),
    "csc": (dict(mode="csc"), "momentum_sgd", 1),
    "lars_guard": (dict(mode="lazy", guard=True), "lars", 1),
    "int8": (dict(mode="lazy", wire_format="int8"), "momentum_sgd", 1),
    "adamw_mono": (dict(mode="dense", overlap="monolithic", guard=True),
                   "adamw", 2),
}
MODES = tuple(RUNS)
# The modes whose reference is JAX's (1, 1) Trainer; the rest JAX's (2, 2).
AT_1X1 = ("dense", "lazy", "adamw_mono")
# The (2, 2) spawn's further modes: the device ring's plain twin on CSC
# and on int8 words (against the flat modes), the float16 wire (against
# JAX's (2, 2) Trainer), and a lazy run with a 2-bucket deferred tail
# that the window pipelines (its eager steps run unpipelined).
MORE = {
    "csc_ring": (dict(mode="csc", collective_algo="pallas_ring"),
                 "momentum_sgd", 1),
    "int8_ring": (dict(mode="lazy", wire_format="int8",
                       collective_algo="pallas_ring"), "momentum_sgd", 1),
    "f16": (dict(mode="lazy", wire_dtype="float16"), "momentum_sgd", 1),
    "window": (dict(mode="lazy", pipeline_tail_buckets=2), "momentum_sgd",
               1),
}
RUNS.update(MORE)
# The window's length; the checkpoints' step (CSC's last warm-up step).
WINDOW = 3
CKPT_STEP = CSC_WARMUP


def _steps(mode):
    return CSC_STEPS if RUNS[mode][0]["mode"] == "csc" else STEPS


def _model(arch, f32):
    cfg = get_smoke(arch)[0]
    return dataclasses.replace(cfg, compute_dtype="float32") if f32 else cfg


def train_cfg(base, arch, mode, f32, **gf_extra):
    """The TrainConfig of ``mode`` in either package (``base`` is its
    ``configs.base``)."""
    gf, opt, micro = RUNS[mode]
    gf = dict(gf)
    if gf.pop("guard", False):
        gf["guard"] = base.GuardConfig()
    kw = dict(bucket_elems=4096, chunk_elems=512, sparsity=0.5,
              warmup_steps=CSC_WARMUP if gf["mode"] == "csc" else 0,
              warmup_stages=1, wire_dtype="float32")
    kw.update(gf, **gf_extra)
    return base.TrainConfig(
        model=_model(arch, f32),
        gradientflow=base.GradientFlowConfig(**kw),
        optimizer=base.OptimizerConfig(
            name=opt, learning_rate=1e-3 if opt == "adamw" else 0.2,
            warmup_steps=1, total_steps=20, schedule="constant"),
        seq_len=S, global_batch=B, attn_chunk=0, microbatches=micro)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _tree(specs, flat, prefix=""):
    """The nested tree of ``specs``' structure (empty subtrees kept: a
    non-parametric norm's ``{}``) with its leaves from ``flat``."""
    return {k: _tree(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in specs.items()}


def _specs(arch):
    return build_model(get_smoke(arch)[0]).param_specs()


# -- the JAX side (imported in the functions: the port's ranks import this
# module and load no JAX) ----------------------------------------------------


@contextlib.contextmanager
def jax_vma_check_off():
    """JAX's Trainer with ``check_vma=False`` on its shard_maps."""
    import repro.launch.trainer as j_trainer_mod
    real = j_trainer_mod.compat_shard_map
    with mock.patch.object(j_trainer_mod, "compat_shard_map",
                           lambda *a, **k: real(*a, **{**k,
                                                       "check_vma": False})):
        yield


def jax_run(arch, mode, f32, mesh_shape=(1, 1), params=None, steps=STEPS,
            snap=None, save=None):
    """(losses, params as numpy after ``snap`` steps (default: the last),
    initial params) of JAX's Trainer (``steps`` 0: only the initial
    parameters). ``save``: a directory JAX's ``CheckpointManager`` saves
    the state to after ``snap`` steps."""
    import jax
    from repro.configs import base as j_base
    from repro.configs import get_smoke as j_get_smoke
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.launch.trainer import Trainer as JTrainer
    from repro.parallel.collectives import compat_set_mesh

    cfg = train_cfg(j_base, arch, mode, f32)
    mesh = j_make_mesh(mesh_shape, ("data", "model"))
    snap = steps if snap is None else snap
    data = SyntheticLM(cfg.model.vocab_size, seed=0)
    losses, fns = [], {}
    with compat_set_mesh(mesh), jax_vma_check_off():
        trainer = JTrainer(cfg, mesh, j_get_smoke(arch)[1])
        state = trainer.init_state(jax.random.PRNGKey(0))
        if params is not None:  # {leaf path: array}
            state = state._replace(params=jax.tree_util.tree_map_with_path(
                lambda path, s: jax.device_put(
                    params["/".join(k.key for k in path)], s),
                trainer.param_shardings))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        out = init
        for t in range(steps):
            stage = trainer.gf.stage_for_step(t)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage,
                                                            donate=False)
            state, m = fns[stage.index](state, jax.device_put(
                data.batch(t, B, S)))
            losses.append(float(m["loss"]))
            if t + 1 == snap:
                out = jax.tree_util.tree_map(np.asarray, state.params)
                if save is not None:
                    from repro.checkpoint.manager import CheckpointManager
                    CheckpointManager(save).save(snap, state, blocking=True)
    return losses, out, init


def jax_window(params, mesh_shape=(2, 2)):
    """(losses, final params) of JAX's ``build_train_window(WINDOW)`` on
    the 'window' mode's config (a 2-bucket deferred tail, pipelined)."""
    import jax
    from repro.configs import base as j_base
    from repro.configs import get_smoke as j_get_smoke
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.launch.trainer import Trainer as JTrainer
    from repro.parallel.collectives import compat_set_mesh

    cfg = train_cfg(j_base, "olmo-1b", "window", True)
    mesh = j_make_mesh(mesh_shape, ("data", "model"))
    data = SyntheticLM(cfg.model.vocab_size, seed=0)
    stacked = [data.batch(t, B, S) for t in range(WINDOW)]
    stacked = {k: np.stack([b[k] for b in stacked]) for k in stacked[0]}
    with compat_set_mesh(mesh), jax_vma_check_off():
        trainer = JTrainer(cfg, mesh, j_get_smoke("olmo-1b")[1])
        state = trainer.init_state(jax.random.PRNGKey(0))
        state = state._replace(params=jax.tree_util.tree_map_with_path(
            lambda path, s: jax.device_put(
                params["/".join(k.key for k in path)], s),
            trainer.param_shardings))
        state, m = trainer.build_train_window(WINDOW)(
            state, jax.device_put(stacked))
        return (np.asarray(m["loss"]),
                jax.tree_util.tree_map(np.asarray, state.params))


def batches(vocab, steps=CSC_STEPS):
    from repro.data.synthetic import SyntheticLM
    data = SyntheticLM(vocab, seed=0)
    return {f"{k}{t}": np.asarray(v) for t in range(steps)
            for k, v in data.batch(t, B, S).items()}


# JAX's own (2, 2) runs: CSC through its first sparse step (the
# parameters and, saved to a checkpoint, the state after the warm-up),
# guarded LARS, int8, the float16 wire and the window ('window'), in two
# subprocesses (each run compiles its own programs).
JAX_22 = {"csc": dict(steps=CSC_WARMUP + 1, snap=CSC_WARMUP, save=True),
          "lars_guard": {}, "int8": {}, "f16": {}, "window": {}}
JAX_22_SPLIT = (("csc", "lars_guard", "int8"), ("f16", "window"))

_JAX_22 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{tests!r}, {src!r}]
import numpy as np
from test_torch_model_axis import jax_run, jax_window, _flat, JAX_22
params = dict(np.load({weights!r}))
out = {{}}
for mode in {modes!r}:
    kw = JAX_22[mode]
    kw = dict(kw, save={ckpt!r}) if kw.get("save") else kw
    if mode == "window":
        losses, final = jax_window(params)
    else:
        losses, final, _ = jax_run("olmo-1b", mode, True, (2, 2), params,
                                   **kw)
    out[mode + "/losses"] = np.asarray(losses)
    out.update({{mode + "/p/" + k: v for k, v in _flat(final).items()}})
np.savez({out!r}, **out)
"""


def jax_csc_reduce(gs, hgs, basis, k, chunk, bucket_elems, momentum=0.9):
    """``repro.core.csc.csc_reduce`` on each data rank's pool ``gs[d]``
    and history ``hgs[d]``, state norms ``basis``, the data axis's psum
    over a ``vmap``: (grads, hg, chunk norms), one row a data rank."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import GradientFlowConfig as JGF
    from repro.core import csc as j_csc

    n = len(gs)
    cfg = JGF(mode="csc", chunk_elems=chunk, bucket_elems=bucket_elems,
              momentum=momentum, wire_dtype="float32", use_kernels=False)
    bounds = j_csc.wire_bucket_boundaries(k, chunk, bucket_elems)

    def f(g, hg):
        res = j_csc.csc_reduce(g, j_csc.CSCState(hg=hg,
                                                 chunk_norms=jnp.asarray(
                                                     basis)),
                               cfg, num_selected=k, bucket_boundaries=bounds,
                               num_data_shards=n)
        return res.grads, res.state.hg, res.state.chunk_norms

    out = jax.jit(jax.vmap(f, axis_name="data"))(jnp.asarray(np.stack(gs)),
                                                 jnp.asarray(np.stack(hgs)))
    return [np.asarray(x) for x in out]


def check_csc_steps(recs, model_groups, data_groups, chunk, sparse):
    """Hold each sparse step's records (``record_csc``; ``recs[rank]`` the
    rank's npz) to the summed selection: for each model group the ids
    equal across its ranks and ``repro.core.csc.select_chunks``' on the
    numpy sum of their norms (which is the basis each rank selected
    on); for each data group the reduce ``jax_csc_reduce``'s given that
    basis, to 1e-6 as ``tests/test_torch_csc.py`` holds one reduction."""
    import jax.numpy as jnp
    from repro.core import csc as j_csc

    for s in range(sparse):
        def rec(r, key):
            return recs[r][f"csc/s{s}/{key}"]
        k = int(rec(0, "k"))
        for group in model_groups:
            summed = np.sum([rec(r, "norms") for r in group], axis=0,
                            dtype=np.float32)
            want = np.asarray(j_csc.select_chunks(jnp.asarray(summed),
                                                  k)[0])
            for r in group:
                np.testing.assert_array_equal(rec(r, "basis"), summed)
                np.testing.assert_array_equal(rec(r, "idx"), want,
                                              err_msg=f"step {s} rank {r}")
        for group in data_groups:
            grads, hg, norms = jax_csc_reduce(
                [rec(r, "g") for r in group], [rec(r, "hg") for r in group],
                rec(group[0], "basis"), k, chunk,
                int(rec(group[0], "bucket_elems")))
            for i, r in enumerate(group):
                g_out = rec(r, "g_out")
                mask = np.zeros(g_out.size // chunk, bool)
                mask[rec(r, "idx")] = True
                got = np.where(np.repeat(mask, chunk), g_out, 0.0)
                for a, b, what in ((got, grads[i], "grads"),
                                   (rec(r, "hg_out"), hg[i], "hg"),
                                   (rec(r, "norms_out"), norms[i], "norms")):
                    np.testing.assert_allclose(
                        a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                        err_msg=f"step {s} rank {r} {what}")


# -- serving under the model axis (shared with the families' test) -----------

SERVE_PROMPT, SERVE_STEPS = 8, 4
# olmo-smoke's serving at mesh (2, 2): the batch over the data axis, and
# one row (long context: not split).
SERVE_BATCHES = (4, 1)
# f32 serving against JAX's build_serve_step: logits and each cache leaf
# within 2e-5 of the tensor's largest magnitude (the row-parallel sums and
# the partials' combine add in another order), the index exactly.
SERVE_RTOL = 2e-5
# build_serve_step's variants whose returned rules are held to JAX's:
# (mode, flash_decode, kv_seq_shard).
RULE_VARIANTS = (("prefill", False, None), ("decode", False, None),
                 ("decode", True, None), ("decode", False, "model"),
                 ("decode", True, "model"))


def serve_inputs(cfg, batch, seed=7):
    """{'s/tokens': (B, prompt + steps) int32 ((..., K) for audio), and
    for a vlm 's/vision': (B, V, D) f32}, from seeded numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, SERVE_PROMPT + SERVE_STEPS) + (
        (cfg.num_codebooks,) if cfg.family == "audio" else ())
    out = {"s/tokens": rng.integers(0, cfg.vocab_size, shape)
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["s/vision"] = rng.standard_normal(
            (batch, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def serve_calls(inputs, rows=slice(None)):
    """The prefill's batch (the prompt, a vlm's vision embeddings) and
    each decode step's token, of the rows ``rows``."""
    toks = inputs["s/tokens"][rows]
    first = {"tokens": toks[:, :SERVE_PROMPT]}
    if "s/vision" in inputs:
        first["vision_embeds"] = inputs["s/vision"][rows]
    return [first] + [{"tokens": toks[:, t:t + 1]} for t in range(
        SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS)]


def serve_shape(base, batch):
    return base.ShapeConfig(name="serve",
                            seq_len=SERVE_PROMPT + SERVE_STEPS,
                            global_batch=batch, kind="decode")


def cache_leaves(cache):
    """A cache's fields in order, nested NamedTuples flattened."""
    if hasattr(cache, "_fields"):
        return [x for f in cache for x in cache_leaves(f)]
    return [cache]


def jax_serve(trainer, params, inputs, batch):
    """JAX's ``build_serve_step`` under the caller's mesh, f32 cache: a
    prefill, then the decode steps naive and ``split_combine``, each from
    the prefill's cache: {'0' | '1': [(logits, [cache leaves]) a call]}
    (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as j_base

    cfg = trainer.cfg.model
    sc = serve_shape(j_base, batch)
    max_len = SERVE_PROMPT + SERVE_STEPS + (
        cfg.num_vision_tokens if cfg.family == "vlm" else 0)
    calls = [{k: jnp.asarray(v) for k, v in c.items()}
             for c in serve_calls(inputs)]
    prefill, _ = trainer.build_serve_step(sc, mode="prefill")
    lg, cache = prefill(params, calls[0], trainer.model.init_cache(
        batch, max_len, dtype=jnp.float32))
    first = (np.asarray(lg), [np.asarray(x) for x in
                              jax.tree_util.tree_leaves(tuple(cache))])
    out = {}
    for split in (0, 1):
        decode, _ = trainer.build_serve_step(sc, mode="decode",
                                             split_combine=bool(split))
        c, rec = jax.tree_util.tree_map(jnp.array, cache), [first]
        for b in calls[1:]:
            lg, c = decode(params, b, c)
            rec.append((np.asarray(lg), [
                np.asarray(x) for x in jax.tree_util.tree_leaves(tuple(c))]))
        out[str(split)] = rec
    return out


def save_jax_serve(out, prefix, saved):
    for split, rec in out.items():
        for i, (lg, leaves) in enumerate(rec):
            saved[f"{prefix}/{split}/lg{i}"] = lg
            for j, x in enumerate(leaves):
                saved[f"{prefix}/{split}/c{i}/{j}"] = x


def rules_json(rules):
    return json.dumps(rules, sort_keys=True)


def port_serve(trainer, local, inputs, batch, saved, prefix):
    """The port's serving under ``trainer``'s mesh from this rank's f32
    blocks ``local``: its ``serve_local`` weights, its data rank's rows,
    its cache blocks (``init_serve_cache``, f32), a prefill and the
    decode steps naive and ``split_combine``, each from a fresh cache.
    Saves each call's logits and cache leaves, the model group's
    all-reduces against ``expected_serve_all_reduces``, the returned
    rules, and the rules of each of RULE_VARIANTS with whether
    ``build_serve_step`` builds it."""
    sc = serve_shape(t_base, batch)
    params = trainer.serve_local(local)
    calls = serve_calls(inputs, trainer.serve_rows(batch))
    prefill, rules = trainer.build_serve_step(sc, mode="prefill")
    saved[f"{prefix}/rules"] = np.asarray(rules_json(rules))
    for split in (0, 1):
        decode, d_rules = trainer.build_serve_step(
            sc, mode="decode", split_combine=bool(split))
        cache = trainer.init_serve_cache(sc, rules, torch.float32)
        counts = []
        for i, b in enumerate(calls):
            step, mode = (prefill, "prefill") if i == 0 \
                else (decode, "decode")
            before = trace.counters["model_axis"]["all_reduces"]
            lg, cache = step(params, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, cache)
            counts.append((trace.counters["model_axis"]["all_reduces"]
                           - before,
                           trainer.expected_serve_all_reduces(
                               mode, rules if i == 0 else d_rules)))
            saved[f"{prefix}/{split}/lg{i}"] = lg.numpy().copy()
            for j, x in enumerate(cache_leaves(cache)):
                saved[f"{prefix}/{split}/c{i}/{j}"] = \
                    convert.cache_to_numpy(x).copy()
        saved[f"{prefix}/{split}/all_reduces"] = np.asarray(counts)
    for v, (mode, flash, kv) in enumerate(RULE_VARIANTS):
        saved[f"{prefix}/variant{v}"] = np.asarray(rules_json(
            trainer.serve_step_rules(sc, mode=mode, kv_seq_shard=kv,
                                     flash_decode=flash)))
        try:
            trainer.build_serve_step(sc, mode=mode, kv_seq_shard=kv,
                                     flash_decode=flash)
            saved[f"{prefix}/variant{v}/built"] = np.asarray(True)
        except ValueError:
            saved[f"{prefix}/variant{v}/built"] = np.asarray(False)


def check_serving(want, ranks, prefix, case_cfg, mesh_shape, batch):
    """The ranks' serving (``port_serve``) against JAX's (``jax_serve``,
    one device): every call's logits (each data rank's rows) and the
    cache joined with ``convert.unshard_cache`` within SERVE_RTOL (and
    cut back by ``convert.shard_cache`` into each rank's blocks bit for
    bit), the logits the same bits on every rank of a model group, the
    model group's all-reduces of every call the expected function's."""
    model = build_model(case_cfg)
    axes = model.cache_logical_axes()
    rules = json.loads(str(ranks[0][f"{prefix}/rules"]))
    m = mesh_shape[-1]
    d = len(ranks) // m
    for split in ("0", "1"):
        for r in ranks:
            got = r[f"{prefix}/{split}/all_reduces"]
            assert (got[:, 0] == got[:, 1]).all(), (prefix, split, got)
        for i in range(1 + SERVE_STEPS):
            w = want[f"{prefix}/{split}/lg{i}"]
            for r, part in enumerate(ranks):
                g = part[f"{prefix}/{split}/lg{i}"]
                np.testing.assert_array_equal(
                    g, ranks[r - r % m][f"{prefix}/{split}/lg{i}"])
                rows = w if g.shape[0] == batch else w[
                    (r // m) * g.shape[0]:(r // m + 1) * g.shape[0]]
                err = np.abs(g - rows).max() / np.abs(rows).max()
                assert err <= SERVE_RTOL, (prefix, split, i, r, err)
            n = len([k for k in want if k.startswith(
                f"{prefix}/{split}/c{i}/")])
            parts = [type(axes)(*_unflatten(axes, [
                p[f"{prefix}/{split}/c{i}/{j}"] for j in range(n)]))
                for p in ranks]
            joined = convert.unshard_cache(parts, axes, rules, mesh_shape)
            # shard_cache cuts the joined cache back into each rank's
            # blocks, bit for bit.
            for r, part in enumerate(parts):
                for a, b in zip(cache_leaves(convert.shard_cache(
                        joined, axes, rules, mesh_shape, r)),
                        cache_leaves(part)):
                    assert a.tobytes() == b.tobytes(), (prefix, i, r)
            whole = cache_leaves(joined)
            assert len(whole) == n and d * m == len(ranks)
            for j, g in enumerate(whole):
                wj = want[f"{prefix}/{split}/c{i}/{j}"]
                assert g.shape == wj.shape, (prefix, i, j, g.shape, wj.shape)
                if g.dtype.kind == "i":
                    np.testing.assert_array_equal(g, wj)
                    continue
                top = max(float(np.abs(wj).max()), 1e-30)
                err = float(np.abs(g.astype(np.float32) - wj).max())
                assert err <= SERVE_RTOL * top, (prefix, split, i, j, err)


def _unflatten(axes, leaves):
    """``leaves`` (``cache_leaves``' order) in the NamedTuples of
    ``axes``, field by field."""
    out, it = [], iter(leaves)

    def build(a):
        if hasattr(a, "_fields"):
            return type(a)(*(build(f) for f in a))
        return next(it)
    return [build(f) for f in axes]


# -- the port's ranks ---------------------------------------------------------

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=world, rank=rank)
    from test_torch_model_axis import rank_main
    rank_main(rank, world, out)
    dist.destroy_process_group()
""")


def port_trainer(arch, mode, f32, mesh, use_kernels=True):
    return Trainer(train_cfg(t_base, arch, mode, f32,
                             use_kernels=use_kernels),
                   device="cpu", mesh=mesh)


@contextlib.contextmanager
def record_csc(records):
    """Record every sparse CSC step the staged engine runs while entered,
    as numpy: the selection's basis and ids (``csc.select_chunks``' input
    and output), the step's staging pool, hg and own chunk norms before
    it, and after it the post-reduce pool, hg and norms."""
    from repro_torch.core import csc as csc_mod
    from repro_torch.core import engine

    real_select = csc_mod.select_chunks
    real_run = engine.OverlapEngine._run_csc
    picks = []

    def select(basis, k):
        idx, mask = real_select(basis, k)
        picks.append((basis.numpy().copy(), idx.numpy().copy()))
        return idx, mask

    def run(self, plan, g, master, leaves, opt_state, gfstate, lr):
        before = dict(g=g.numpy().copy(), hg=gfstate.hg.numpy().copy(),
                      norms=gfstate.chunk_norms.numpy().copy())
        outs, gf = real_run(self, plan, g, master, leaves, opt_state,
                            gfstate, lr)
        (basis, idx), = picks
        picks.clear()
        records.append(dict(before, k=np.asarray(plan.num_selected),
                            basis=basis, idx=idx, g_out=g.numpy().copy(),
                            hg_out=gf.hg.numpy().copy(),
                            norms_out=gf.chunk_norms.numpy().copy(),
                            bucket_elems=np.asarray(self.gf.bucket_elems)))
        return outs, gf

    with mock.patch.object(csc_mod, "select_chunks", select), \
            mock.patch.object(engine.OverlapEngine, "_run_csc", run):
        yield


def replicated_leaves(trainer):
    """The flat names of the leaves the trainer's rules replicate."""
    from repro_torch.core.pool import flatten_tree
    from repro_torch.parallel import sharding
    return ["/".join(p) for p, s in flatten_tree(trainer.specs)
            if sharding.model_dim(s, trainer.rules) is None]


def train_steps(trainer, state, inputs, rows, steps, saved, prefix,
                snap=None, first=0, on_step=None):
    """Run steps ``first`` to ``steps`` - 1 on the inputs' batches (this
    rank's ``rows``); save the losses, the guard's trips and scales, the
    replicated leaves after every step, the parameters after ``snap``
    steps (and at the end) under ``prefix``; ``on_step(t, state)`` after
    each step. Returns the state."""
    fns, losses, trips, scales = {}, [], [], []
    rep = replicated_leaves(trainer)
    for t in range(first, steps):
        stage = trainer.gf.stage_for_step(t)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        batch = {k: torch.from_numpy(inputs[f"{k}{t}"][rows])
                 for k in ("tokens", "labels")}
        state, m = fns[stage.index](state, batch)
        losses.append(float(m["loss"]))
        if "guard_tripped" in m:
            trips.append(float(m["guard_tripped"]))
            scales.append(float(state.guard.scale))
        # Copies: the state's tensors are updated in place.
        flat = {k: v.copy() for k, v in _flat(convert.params_to_numpy(
            state.params)).items()}
        for name in rep:
            saved[f"{prefix}/rep{t}/{name}"] = flat[name]
        if t + 1 == snap:
            for name, v in flat.items():
                saved[f"{prefix}/snap/{name}"] = v
        if on_step is not None:
            on_step(t, state)
    saved[f"{prefix}/losses"] = np.asarray(losses)
    if trips:
        saved[f"{prefix}/tripped"] = np.asarray(trips)
        saved[f"{prefix}/scales"] = np.asarray(scales)
    for name, v in _flat(convert.params_to_numpy(state.params)).items():
        saved[f"{prefix}/p/{name}"] = v
    return state


def _state_bits(state):
    """Every tensor a skipped step must keep: parameters, optimizer state,
    GradientFlow state (the residual among them), as numpy copies."""
    out = [v.copy() for v in _flat(convert.params_to_numpy(
        state.params)).values()]
    for part in (state.opt, state.gf):
        out += [t.numpy().copy() for t in part
                if isinstance(t, torch.Tensor)]
    return out


def fault_steps(mesh, inputs, rows, saved):
    """qwen3-smoke guarded on the int8 wire with error feedback at mesh
    (1, 2), 3 steps, a NaN in rank 1's block of its first sharded leaf
    at step 1 (rank 0's pool stays clean): per step the verdict, the
    scale and whether every tensor kept its bits."""
    from repro_torch.core.pool import flatten_tree
    from repro_torch.parallel import sharding
    from repro_torch.runtime import faults

    trainer = Trainer(train_cfg(t_base, "qwen3-32b", "int8", False,
                                use_kernels=True,
                                guard=t_base.GuardConfig()),
                      device="cpu", mesh=mesh)
    full = _tree(_specs("qwen3-32b"), {k[2:]: v for k, v in inputs.items()
                                       if k.startswith("p/")})
    state = trainer.init_state(params=convert.params_from_numpy(
        convert.shard_params(full, trainer.rules, 2, mesh.model_index,
                             specs=trainer.specs), "cpu"))
    sharded = next(i for i, (_, s) in enumerate(flatten_tree(trainer.specs))
                   if sharding.model_dim(s, trainer.rules) is not None)
    events = [faults.FaultEvent(step=1, kind="nan",
                                offset=trainer.pool.offsets[sharded] + 3,
                                width=4)] if mesh.model_index == 1 else []
    step = trainer.build_train_step(fault_hook=faults.make_hook(events))
    trips, scales, kept = [], [], []
    for t in range(3):
        before = _state_bits(state)
        state, m = step(state, {k: torch.from_numpy(inputs[f"{k}{t}"][rows])
                                for k in ("tokens", "labels")})
        trips.append(float(m["guard_tripped"]))
        scales.append(float(state.guard.scale))
        kept.append(all(np.array_equal(x, y)
                        for x, y in zip(before, _state_bits(state))))
    saved["fault/tripped"] = np.asarray(trips)
    saved["fault/scales"] = np.asarray(scales)
    saved["fault/kept"] = np.asarray(kept)
    saved["fault/injected"] = np.asarray(len(events))


def wait_for(path, timeout=500.0):
    """Wait until ``path`` exists (a checkpoint another process writes:
    its directory appears by an atomic rename)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def manager(trainer, directory):
    from repro_torch.checkpoint.manager import CheckpointManager
    return CheckpointManager(str(directory),
                             layout=trainer.checkpoint_layout())


def _batch(inputs, rows, steps):
    """The stacked [L, b, s] batches of ``steps`` for this rank's rows."""
    return {k: torch.from_numpy(np.stack([inputs[f"{k}{t}"][rows]
                                          for t in steps]))
            for k in ("tokens", "labels")}


def window_steps(mesh, full, inputs, rows, saved):
    """The 'window' mode: ``build_train_window(WINDOW)`` (pipelined, its
    lane on the local pool) and, from the same weights, WINDOW eager
    steps of the same trainer (unpipelined)."""
    from repro_torch.launch.trainer import is_flushed

    trainer = port_trainer("olmo-1b", "window", True, mesh)
    assert trainer._pipeline_plan() is not None
    local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                 mesh.model_index, specs=trainer.specs)
    init = convert.params_from_numpy(local, "cpu")
    state = trainer.init_state(params=convert.params_from_numpy(local,
                                                                "cpu"))
    state, m = trainer.build_train_window(WINDOW)(
        state, _batch(inputs, rows, range(WINDOW)))
    assert is_flushed(state) and state.step == WINDOW
    saved["window/losses"] = m["loss"].numpy().copy()
    for name, v in _flat(convert.params_to_numpy(state.params)).items():
        saved[f"window/p/{name}"] = v
    state = trainer.init_state(params=init)
    train_steps(trainer, state, inputs, rows, WINDOW, saved, "eager")


def checkpoint_steps(mesh, full, inputs, rows, saved, tmp):
    """Mesh (2, 2): CSC's warm-up steps saved at CKPT_STEP
    (``port_csc``); JAX's (2, 2) checkpoint of the same run restored into
    a fresh state, and its next (first sparse) step; lazy saved at
    CKPT_STEP (``port_lazy``, which the (1, 2) ranks restore)."""
    trainer = port_trainer("olmo-1b", "csc", True, mesh)
    local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                 mesh.model_index, specs=trainer.specs)
    mgr = manager(trainer, os.path.join(tmp, "port_csc"))
    state = trainer.init_state(params=convert.params_from_numpy(local,
                                                                "cpu"))
    train_steps(trainer, state, inputs, rows, CKPT_STEP, saved, "ckpt_csc",
                on_step=lambda t, st: t + 1 == CKPT_STEP and mgr.save(
                    CKPT_STEP, st, blocking=True))
    wait_for(os.path.join(tmp, "jax_csc", f"step_{CKPT_STEP}"))
    fresh = trainer.init_state(seed=1)
    step, state = manager(trainer, os.path.join(tmp, "jax_csc")).restore(
        fresh)
    assert step == CKPT_STEP and state.step == CKPT_STEP
    from repro_torch.checkpoint.manager import flatten
    assert all(a is b for (_, a), (_, b) in zip(flatten(state),
                                                flatten(fresh))
               if isinstance(b, torch.Tensor))
    train_steps(trainer, state, inputs, rows, CKPT_STEP + 1, saved,
                "from_jax", first=CKPT_STEP)
    trainer = port_trainer("olmo-1b", "lazy", True, mesh)
    mgr = manager(trainer, os.path.join(tmp, "port_lazy"))
    state = trainer.init_state(params=convert.params_from_numpy(local,
                                                                "cpu"))
    train_steps(trainer, state, inputs, rows, CKPT_STEP, saved, "ckpt_lazy",
                on_step=lambda t, st: t + 1 == CKPT_STEP and mgr.save(
                    CKPT_STEP, st))
    mgr.wait()


def elastic_steps(mesh, inputs, saved, tmp):
    """Mesh (1, 2): the (2, 2) lazy checkpoint restored at another data
    degree (one data rank, the whole batch) and trained on to STEPS."""
    full = _tree(_specs("olmo-1b"), {k[2:]: v for k, v in inputs.items()
                                     if k.startswith("p/")})
    trainer = port_trainer("olmo-1b", "lazy", True, mesh)
    local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                 mesh.model_index, specs=trainer.specs)
    state = trainer.init_state(params=convert.params_from_numpy(local,
                                                                "cpu"))
    wait_for(os.path.join(tmp, "port_lazy", f"step_{CKPT_STEP}"))
    step, state = manager(trainer, os.path.join(tmp, "port_lazy")).restore(
        state)
    assert step == CKPT_STEP
    train_steps(trainer, state, inputs, slice(0, B), STEPS, saved,
                "elastic", first=CKPT_STEP)


class FailOnce(list):
    """The CLI's window record, raising once after the window that ends
    at ``step`` (a host fault inside the window's call), on every rank."""

    def __init__(self, step):
        super().__init__()
        self.step, self.fired = step, False

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"host fault after step {self.step}")


def cli_runs(args, tmp, saved):
    """The CLI at ``--mesh 1x2`` with ``--ckpt-dir``, windows of 2 and a
    checkpoint every 2 steps, a fault after step 4 and without one."""
    from repro_torch.launch import train

    for name, record in (("fault", FailOnce(4)), ("clean", None)):
        argv = args + ["--steps", "6", "--window-steps", "2",
                       "--ckpt-every", "2", "--ckpt-dir",
                       os.path.join(tmp, f"cli_{name}")]
        trainer, losses, _, stats = train.train(train.parse_args(argv),
                                                record=record)
        saved[f"cli_{name}/losses"] = np.asarray(losses)
        saved[f"cli_{name}/stats"] = np.asarray(json.dumps(stats))
    last = manager(trainer, os.path.join(tmp, "cli_fault"))
    saved["cli_fault/steps"] = np.asarray(last.available_steps())


def rank_main(rank, world, out):
    """One rank of the (2, 2) olmo run (world 4) or of the (1, 2) qwen3
    run, fault, elastic and CLI checks (world 2); saves what the tests
    read."""
    mesh = t_mesh.make_mesh((2, 2) if world == 4 else (1, 2))
    arch, f32, modes = ("olmo-1b", True, MODES + ("csc_ring", "int8_ring",
                                                  "f16")) \
        if world == 4 else ("qwen3-32b", False, ("lazy",))
    tmp = os.path.dirname(out)
    inputs = dict(np.load(os.path.join(tmp, f"{arch}_inputs.npz")))
    full = _tree(_specs(arch), {k[2:]: v for k, v in inputs.items()
                                if k.startswith("p/")})
    rows = slice(mesh.data_index * B // mesh.num_data,
                 (mesh.data_index + 1) * B // mesh.num_data)
    saved = {}
    if world == 4:
        checkpoint_steps(mesh, full, inputs, rows, saved, tmp)
    for mode in modes:
        before = trace.counters["model_axis"]["all_reduces"]
        trainer = port_trainer(arch, mode, f32, mesh)
        local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                     mesh.model_index, specs=trainer.specs)
        state = trainer.init_state(params=convert.params_from_numpy(
            local, "cpu"))
        recs = []
        with record_csc(recs) if mode == "csc" else contextlib.nullcontext():
            train_steps(trainer, state, inputs, rows, _steps(mode), saved,
                        mode, snap=CSC_WARMUP if mode == "csc" else None)
        for s, r in enumerate(recs):
            saved.update({f"csc/s{s}/{k}": v for k, v in r.items()})
        saved[f"{mode}/all_reduces"] = np.asarray(
            trace.counters["model_axis"]["all_reduces"] - before)
        saved[f"{mode}/pool"] = np.asarray(
            [trainer.pool.size, trainer.global_pool])
        saved[f"{mode}/algos"] = np.asarray(
            [t.algo.name for t in trainer.engine.plan_for(
                trainer.gf.stages[-1]).tasks])
    if world == 4:
        window_steps(mesh, full, inputs, rows, saved)
        # Serving olmo-smoke: 'serve_batch' over the data axis at batch
        # 4, long context (every data rank the whole batch) at batch 1.
        trainer = port_trainer(arch, "lazy", True, mesh)
        local = convert.params_from_numpy(convert.shard_params(
            full, trainer.rules, mesh.model_size, mesh.model_index,
            specs=trainer.specs), "cpu")
        for b in SERVE_BATCHES:
            port_serve(trainer, local, {k: v[:b] for k, v in inputs.items()
                                        if k.startswith("s/")},
                       b, saved, f"serve{b}")
    if world == 2:
        fault_steps(mesh, inputs, rows, saved)
        olmo = dict(np.load(os.path.join(tmp, "olmo-1b_inputs.npz")))
        elastic_steps(mesh, olmo, saved, tmp)
        from repro_torch.launch import train
        args = ["--arch", "qwen3-32b", "--reduced", "--mesh", "1x2",
                "--batch", "2", "--seq-len", "32", "--gf-mode", "lazy",
                "--device", "cpu"]
        cli_runs(args, tmp, saved)
        args += ["--steps", "2"]
        saved["cli_losses"] = np.asarray(
            train.main(args + ["--window-steps", "1"]))
        saved["cli_lars_fp8_losses"] = np.asarray(train.main(
            args + ["--window-steps", "1", "--optimizer", "lars",
                    "--wire-format", "fp8_e4m3"]))
    np.savez(out, **saved)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, world, tmp):
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                              port, str(tmp / f"w{world}_rank{r}.npz")],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _wait(procs, timeout=600):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, (out[-2000:], err[-4000:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the JAX Trainer's initial weights and the batches, start the
    JAX (2, 2) subprocess and both spawns, compute the JAX (1, 1)
    references meanwhile, then collect everything."""
    tmp = tmp_path_factory.mktemp("model_axis")
    tests = os.path.dirname(os.path.abspath(__file__))
    ref = {}
    for arch, f32 in (("olmo-1b", True), ("qwen3-32b", False)):
        init = ref[(arch, "init")] = _flat(jax_run(arch, "lazy", f32,
                                                   steps=0)[2])
        if arch == "olmo-1b":
            np.savez(tmp / "olmo_init.npz", **init)
        np.savez(tmp / f"{arch}_inputs.npz",
                 **batches(get_smoke(arch)[0].vocab_size),
                 **serve_inputs(get_smoke(arch)[0], max(SERVE_BATCHES)),
                 **{f"p/{k}": v for k, v in init.items()})
    jax22 = [subprocess.Popen(
        [sys.executable, "-c", _JAX_22.format(
            tests=tests, src=SRC, weights=str(tmp / "olmo_init.npz"),
            out=str(tmp / f"jax22_{i}.npz"), ckpt=str(tmp / "jax_csc"),
            modes=modes)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, modes in enumerate(JAX_22_SPLIT)]
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(tests=tests, src=SRC))
    procs = _spawn(script, 4, tmp) + _spawn(script, 2, tmp)
    for mode in AT_1X1:
        ref[("olmo-1b", mode)] = jax_run("olmo-1b", mode, True)[:2]
    ref[("qwen3-32b", "lazy")] = jax_run("qwen3-32b", "lazy", False)[:2]
    ref["serve"] = jax_serve_olmo(ref[("olmo-1b", "init")])
    _wait(procs)
    _wait(jax22)
    j22 = {k: v for i in range(len(JAX_22_SPLIT))
           for k, v in np.load(tmp / f"jax22_{i}.npz").items()}
    for mode in JAX_22:
        ref[("olmo-1b", mode)] = (
            list(j22[f"{mode}/losses"]),
            _tree(_specs("olmo-1b"), {k[len(mode) + 3:]: v
                                      for k, v in j22.items()
                                      if k.startswith(f"{mode}/p/")}))
    ranks = {w: [dict(np.load(tmp / f"w{w}_rank{r}.npz")) for r in range(w)]
             for w in (4, 2)}
    ref["tmp"] = tmp
    return ref, ranks


def jax_serve_olmo(init):
    """JAX's (1, 1) serving of olmo-smoke in f32 from the weights
    ``init`` (flat) at each of SERVE_BATCHES: {key: array} in
    ``port_serve``'s keys."""
    from repro.configs import base as j_base
    from repro.configs import get_smoke as j_get_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.launch.trainer import Trainer as JTrainer
    from repro.parallel.collectives import compat_set_mesh

    inputs = serve_inputs(get_smoke("olmo-1b")[0], max(SERVE_BATCHES))
    mesh = make_host_mesh()
    out = {}
    with compat_set_mesh(mesh):
        trainer = JTrainer(train_cfg(j_base, "olmo-1b", "lazy", True), mesh,
                           j_get_smoke("olmo-1b")[1])
        params = _tree(_specs("olmo-1b"), init)
        for b in SERVE_BATCHES:
            save_jax_serve(jax_serve(trainer, params, {
                k: v[:b] for k, v in inputs.items()}, b), f"serve{b}", out)
    return out


@pytest.mark.parametrize("batch", SERVE_BATCHES)
def test_serving_at_2x2_matches_jax(runs, batch):
    """olmo-smoke served by four ranks at mesh (2, 2) (its KV heads split
    over 'model'), at batch 4 each data rank its two rows, at batch 1
    (long context) every data rank the row, against JAX's (1, 1)
    ``build_serve_step``: logits and caches, naive and split_combine,
    the decode's all-reduces the expected function's."""
    ref, ranks = runs
    rules = json.loads(str(ranks[4][0][f"serve{batch}/rules"]))
    assert rules["serve_batch"] == (["data"] if batch == 4 else None)
    assert rules["kv_heads"] == "model" and rules["kv_seq"] is None
    check_serving(ref["serve"], ranks[4], f"serve{batch}",
                  _model("olmo-1b", True), (2, 2), batch)


def _gathered(parts, prefix, arch):
    specs = _specs(arch)
    local = [_tree(specs, {k[len(prefix):]: v for k, v in p.items()
                           if k.startswith(prefix)}) for p in parts]
    return convert.unshard_params(local, get_smoke(arch)[1], specs=specs)


def _assert_params(got, want, rtol, atol, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def assert_updates_close(got, want, init, bound, what):
    """Each leaf's update (final minus ``init``) against the reference's
    in norm, within ``bound`` of its size."""
    g, w = _flat(got), _flat(want)
    errs = {n: np.linalg.norm((g[n] - init[n]) - (w[n] - init[n]))
            / np.linalg.norm(w[n] - init[n]) for n in w}
    assert max(errs.values()) <= bound, (what, errs)


def assert_replicas_equal(ranks, groups, prefix):
    """Every replicated leaf saved after every step under ``prefix``
    (``train_steps``' ``rep<t>/`` entries) is the same bits on every rank
    of each model group. Returns how many leaf copies were compared."""
    keys = [k for k in ranks[groups[0][0]] if k.startswith(f"{prefix}/rep")]
    for group in groups:
        for k in keys:
            for r in group[1:]:
                np.testing.assert_array_equal(ranks[r][k],
                                              ranks[group[0]][k], err_msg=k)
    return len(keys)


# Model groups (a data index's ranks) and data groups (a model index's)
# of the (2, 2) mesh: rank = data index * 2 + model index.
MODEL_GROUPS_22, DATA_GROUPS_22 = ((0, 1), (2, 3)), ((0, 2), (1, 3))


@pytest.mark.parametrize("mode", MODES)
def test_mesh_2x2_matches_jax(runs, mode):
    ref, ranks = runs
    want_losses, want_params = ref[("olmo-1b", mode)]
    r = ranks[4]
    csc = mode == "csc"
    for p in r:
        got = p[f"{mode}/losses"]
        # CSC: JAX's (2, 2) Trainer through its first sparse step only
        # (its selection is per rank, the port's the model group's).
        np.testing.assert_allclose(got[:len(want_losses)], want_losses,
                                   rtol=1e-5 if mode == "int8" else RTOL,
                                   err_msg=mode)
        assert len(got) == _steps(mode) and np.isfinite(got).all()
        assert p[f"{mode}/pool"][1] == 2 * p[f"{mode}/pool"][0]
        assert p[f"{mode}/all_reduces"] > 0
        if f"{mode}/tripped" in p:
            assert not p[f"{mode}/tripped"].any(), p[f"{mode}/tripped"]
    # Model ranks (0, 1) and (2, 3) hold the data indices' copies: the
    # data-parallel mean leaves them equal bit for bit (the serving
    # entries are each data rank's own rows: test_serving_at_2x2_*).
    for a, b in ((0, 2), (1, 3)):
        for k in r[a]:
            # each data rank's own pool
            if not k.startswith(("csc/s", "serve")):
                np.testing.assert_array_equal(r[a][k], r[b][k], err_msg=k)
    # Replicated leaves (olmo has no norm weights: its norms are
    # non-parametric) are none here; the gathered tree is JAX's.
    got = _gathered(r[:2], f"{mode}/{'snap' if csc else 'p'}/", "olmo-1b")
    if mode == "int8":
        assert_updates_close(got, want_params, ref[("olmo-1b", "init")],
                             1e-2, mode)
    elif mode == "adamw_mono":
        assert_updates_close(got, want_params, ref[("olmo-1b", "init")],
                             1e-3, mode)
        _assert_params(got, want_params, RTOL, 0.1 * 1e-3, mode)
    else:
        _assert_params(got, want_params, RTOL, 1e-6, mode)
    assert_replicas_equal(r, MODEL_GROUPS_22, mode)
    if csc:
        check_csc_steps(r, MODEL_GROUPS_22, DATA_GROUPS_22, 512,
                        CSC_STEPS - CSC_WARMUP)


def test_mesh_1x2_qwen3_bf16_matches_jax(runs):
    ref, ranks = runs
    want_losses, want_params = ref[("qwen3-32b", "lazy")]
    r = ranks[2]
    for p in r:
        np.testing.assert_allclose(p["lazy/losses"], want_losses,
                                   rtol=6e-3)
    # The replicated leaves (norm scales, QK-norm) are the same bits on
    # both model ranks: their gradients are all-reduced sums.
    # Five replicated leaves: the final, attention and MLP norm scales,
    # the QK-norm scales.
    assert assert_replicas_equal(r, [(0, 1)], "lazy") == 5 * STEPS
    got = _gathered(r, "lazy/p/", "qwen3-32b")
    # The bf16 products and row-parallel sums round in another order, so
    # each leaf's update (final minus initial) is held against JAX's in
    # norm: within 2^-4 of its size (0.016-0.026 measured on the CPU; a
    # gradient missing its model-group sum is off by order 1).
    assert_updates_close(got, want_params, ref[("qwen3-32b", "init")],
                         2 ** -4, "qwen3 bf16")
    for key in ("cli_losses", "cli_lars_fp8_losses"):
        assert r[0][key].shape == (2,) and np.isfinite(r[0][key]).all()
        np.testing.assert_array_equal(r[0][key], r[1][key])


def test_one_rank_fault_skips_on_every_model_rank(runs):
    """The NaN lies in rank 1's pool only; the group verdict trips both
    ranks at step 1, each keeps every tensor's bits (parameters, momentum,
    the int8 residual), both halve the scale, and step 2 commits."""
    r = runs[1][2]
    assert [int(p["fault/injected"]) for p in r] == [0, 1]
    init = float(t_base.GuardConfig().init_scale)
    for p in r:
        np.testing.assert_array_equal(p["fault/tripped"], [0.0, 1.0, 0.0])
        np.testing.assert_array_equal(p["fault/kept"], [False, True, False])
        np.testing.assert_array_equal(p["fault/scales"],
                                      [init, init / 2, init / 2])


def _params_of(r, prefix):
    return _gathered(r[:2], prefix, "olmo-1b")


@pytest.mark.parametrize("mode,flat", [("csc_ring", "csc"),
                                       ("int8_ring", "int8")])
def test_pallas_ring_on_csc_and_int8_words_matches_flat(runs, mode, flat):
    """Each data group's reduce through the ring's plain twin (the words
    of CSC's compacted chunks, the int8 words) against the flat gloo sum:
    two data ranks' values add in either order to the same f32 (and the
    int8 sums are exact), so within 2e-5 as every f32 sum-order bound
    here; every bucket took the ring."""
    r = runs[1][4]
    for p in r:
        np.testing.assert_allclose(p[f"{mode}/losses"], p[f"{flat}/losses"],
                                   rtol=RTOL)
        assert set(p[f"{mode}/algos"]) == {"pallas_ring"}
        assert set(p[f"{flat}/algos"]) == {"flat"}
    _assert_params(_params_of(r, f"{mode}/p/"), _params_of(r, f"{flat}/p/"),
                   RTOL, 1e-6, mode)


def test_float16_wire_matches_jax(runs):
    """The float16 wire at (2, 2) against JAX's (2, 2) Trainer, at the
    port's half-precision wire bound without a model axis
    (``tests/test_torch_trainer.py``): losses within 1e-5, parameters
    within 1e-4 absolute (a last-bit gradient difference can flip the
    wire's rounding of a few elements)."""
    ref, ranks = runs
    want_losses, want = ref[("olmo-1b", "f16")]
    for p in ranks[4]:
        np.testing.assert_allclose(p["f16/losses"], want_losses, rtol=1e-5)
    _assert_params(_params_of(ranks[4], "f16/p/"), want, 0, 1e-4, "f16")


def test_window_matches_jax_and_its_eager_steps(runs):
    """``build_train_window(3)`` with a 2-bucket deferred tail at (2, 2):
    its losses and flushed parameters against JAX's (2, 2)
    ``build_train_window`` within 1e-5 (parameters 2e-5, the f32
    sum-order bound), and bit for bit the port's own eager steps (the
    lane on the local pool applies the same updates in the same order)."""
    ref, ranks = runs
    want_losses, want = ref[("olmo-1b", "window")]
    for p in ranks[4]:
        np.testing.assert_allclose(p["window/losses"], want_losses,
                                   rtol=1e-5)
        np.testing.assert_array_equal(p["window/losses"], p["eager/losses"])
        for k in p:
            if k.startswith("window/p/"):
                np.testing.assert_array_equal(
                    p[k], p["eager/p/" + k[len("window/p/"):]], err_msg=k)
    _assert_params(_params_of(ranks[4], "window/p/"), want, RTOL, 1e-6,
                   "window")


def _manifest(d):
    with open(os.path.join(d, f"step_{CKPT_STEP}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_is_jaxs_global_layout(runs):
    """The port's (2, 2) CSC checkpoint after the warm-up and JAX's of the
    same run: the same leaf names, shapes and dtypes (the parameters
    whole, the momentum and chunk norms [2 x pool], hg [2, 2 x pool]), and
    the same arrays within the f32 bound (2e-5; hg is zero after the
    dense warm-up in both)."""
    ref, _ = runs
    tmp = ref["tmp"]
    got, want = _manifest(tmp / "port_csc"), _manifest(tmp / "jax_csc")
    assert [(m["name"], m["shape"], m["dtype"], m.get("scratch", False))
            for m in got["leaves"]] == [
        (m["name"], m["shape"], m["dtype"], m.get("scratch", False))
        for m in want["leaves"]]
    shapes = {m["name"]: m["shape"] for m in got["leaves"]}
    trainer = Trainer(train_cfg(t_base, "olmo-1b", "csc", True),
                      device="cpu", mesh=_fake_mesh(2))
    assert shapes["opt/momentum"] == [trainer.global_pool]
    assert shapes["gf/hg"] == [2, trainer.global_pool]
    assert shapes["gf/chunk_norms"] == [trainer.num_chunks_global]
    a = np.load(tmp / "port_csc" / f"step_{CKPT_STEP}" / "arrays.npz")
    b = np.load(tmp / "jax_csc" / f"step_{CKPT_STEP}" / "arrays.npz")
    for i, m in enumerate(got["leaves"]):
        x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
        if m["name"] == "gf/chunk_norms":
            # Each norm sums a chunk's 512 |values|: relative to the norm.
            np.testing.assert_allclose(x, y, rtol=RTOL, err_msg=m["name"])
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-6,
                                       err_msg=m["name"])


def test_jax_checkpoint_restores_into_the_port(runs):
    """JAX's (2, 2) checkpoint restored into the port's (2, 2) ranks, in
    place: the next step's loss is JAX's (within 1e-5)."""
    ref, ranks = runs
    want = ref[("olmo-1b", "csc")][0][CKPT_STEP]
    for p in ranks[4]:
        np.testing.assert_allclose(p["from_jax/losses"], [want], rtol=1e-5)


def test_checkpoint_restored_at_another_data_degree_continues(runs):
    """The port's (2, 2) lazy checkpoint restored at (1, 2), as JAX's
    ``test_elastic_reshard_resume`` does: the losses of the steps after
    it are the uninterrupted (2, 2) run's, within the f32 sum-order bound
    (2e-5; JAX's test allows 2e-4)."""
    _, ranks = runs
    want = ranks[4][0]["lazy/losses"][CKPT_STEP:]
    np.testing.assert_array_equal(ranks[4][0]["ckpt_lazy/losses"],
                                  ranks[4][0]["lazy/losses"][:CKPT_STEP])
    for p in ranks[2]:
        np.testing.assert_allclose(p["elastic/losses"], want, rtol=RTOL)


def test_cli_restarts_from_a_checkpoint_under_a_model_axis(runs):
    """The CLI at ``--mesh 1x2`` with ``--ckpt-dir`` and windows of 2: a
    fault after step 4 restarts both ranks from the checkpoint at 4; the
    losses are the run's without the fault, bit for bit."""
    r = runs[1][2]
    for p in r:
        fault = json.loads(str(p["cli_fault/stats"]))
        clean = json.loads(str(p["cli_clean/stats"]))
        assert fault["restarts"] == 1 and clean["restarts"] == 0, fault
        assert fault["restart_causes"] == ["RuntimeError: host fault after "
                                           "step 4"]
        np.testing.assert_array_equal(p["cli_fault/losses"],
                                      p["cli_clean/losses"])
        assert p["cli_fault/losses"].shape == (6,)
        assert list(p["cli_fault/steps"]) == [2, 4, 6]
    np.testing.assert_array_equal(r[0]["cli_fault/losses"],
                                  r[1]["cli_fault/losses"])


# -- under a model axis in one process ----------------------------------------


def _fake_mesh(m=2):
    return t_mesh.Mesh((1, m), t_mesh.AXES, 0,
                       LevelGroup(None, tuple(range(m)), 0),
                       LevelGroup(None, (0,), 0))


def _cfg(arch="olmo-1b", opt="momentum_sgd", micro=1, **gf):
    kw = dict(mode="lazy", wire_dtype="float32")
    kw.update(gf)
    return t_base.TrainConfig(model=get_smoke(arch)[0],
                              gradientflow=t_base.GradientFlowConfig(**kw),
                              optimizer=t_base.OptimizerConfig(name=opt),
                              seq_len=S, global_batch=B, microbatches=micro)


_TWO_LEVEL = Topology.from_axis_sizes(("node", "gpu"), (1, 1))
# The collective algorithms, a data topology of two levels and the
# float16 wire under a model axis, for the dense family and each other.
COLLECTIVES = {
    "moe": _cfg("arctic-480b", collective_algo="pallas_ring"),
    "vlm": _cfg("internvl2-26b", collective_algo="tree"),
    "audio": _cfg("musicgen-large", topology=_TWO_LEVEL),
    "ssm": _cfg("falcon-mamba-7b", wire_dtype="float16"),
    "hybrid": _cfg("zamba2-2.7b", collective_algo="two_level"),
    "float16_wire": _cfg(wire_dtype="float16"),
    "pallas_ring": _cfg(collective_algo="pallas_ring"),
    "tree": _cfg(collective_algo="tree"),
    "two_level": _cfg(topology=_TWO_LEVEL),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_and_wires_build_under_a_model_axis(name):
    """Each builds over the local pool: its buckets take the named
    algorithm over the config's topology (``auto`` keeps the flat ring:
    on levels of one rank it ties, and a tie goes to flat), on the
    float16 wire's dtype."""
    cfg = COLLECTIVES[name]
    trainer = Trainer(cfg, device="cpu", mesh=_fake_mesh())
    gf = cfg.gradientflow
    assert trainer.global_pool == 2 * trainer.pool.size
    assert trainer.gf_cfg.wire_dtype == gf.wire_dtype
    levels = [(lv.axis, lv.size) for lv in trainer.gf_cfg.topology.levels]
    assert levels == ([("node", 1), ("gpu", 1)] if gf.topology is not None
                      else [("data", 1)])
    want = gf.collective_algo if gf.collective_algo != "auto" else "flat"
    assert {t.algo.name for t in trainer.engine.plan_for().tasks} == {want}


# The update-path features that train under a model axis: each builds
# over the rank's local pool.
FEATURES = {
    "monolithic": _cfg(overlap="monolithic"),
    "int8": _cfg(wire_format="int8"), "fp8": _cfg(wire_format="fp8_e4m3"),
    "guard": _cfg(guard=t_base.GuardConfig()), "lars": _cfg(opt="lars"),
    "adamw": _cfg(opt="adamw"), "microbatches": _cfg(micro=2),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_update_path_features_build_under_a_model_axis(name):
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.scaler import ScalerState

    cfg = FEATURES[name]
    trainer = Trainer(cfg, device="cpu", mesh=_fake_mesh(2))
    local = Trainer(cfg, device="cpu").pool  # the whole model, one rank
    pool, state = trainer.pool, trainer.init_state()
    assert trainer.global_pool == 2 * pool.size < 2 * local.size
    assert trainer.gf.model_axis is trainer.model_axis
    assert trainer.model_axis.size == 2
    if name == "monolithic":
        assert trainer.gf_cfg.overlap == "monolithic"
        assert trainer._pipeline_plan() is None
    elif name in ("int8", "fp8"):
        # Per-chunk scales over the local pool, padded to whole chunks;
        # the error-feedback residual is the local pool's size.
        assert trainer.gf.wire_spec is not None
        assert pool.size % trainer.gf_cfg.chunk_elems == 0
        assert state.gf.residual.shape == (pool.size,)
        assert trainer._census_chunk == trainer.gf_cfg.chunk_elems
    elif name == "guard":
        assert isinstance(state.guard, ScalerState)
        assert float(state.guard.scale) == cfg.gradientflow.guard.init_scale
        assert int(state.guard.skipped) == 0
    elif name == "lars":
        # One trust ratio a local leaf: a sharded leaf's block has its own.
        assert trainer.lars.pool is pool
        master = torch.ones(pool.size)
        assert trainer.lars.ratios(master, master, cfg.optimizer).shape \
            == (len(pool.sizes) + bool(pool.padding),)
    elif name == "adamw":
        assert isinstance(state.opt, AdamWState)
        assert state.opt.mu.shape == state.opt.nu.shape == (pool.size,)
    else:
        assert trainer.cfg.microbatches == 2


def test_selection_without_a_model_axis_is_unchanged():
    """Without a model axis (or with one rank on it) every sparse step
    selects on the state's own norms tensor itself: no collective, the
    ids and bits of the selection before the summed basis."""
    from repro_torch.core import csc as csc_mod
    from repro_torch.parallel.model_axis import ModelAxis

    norms = torch.tensor([3.0, 1.0, 3.0, 0.0, 2.0, 2.0])
    one = ModelAxis(None, 1, 0, {})
    one.all_reduce_ = None  # any collective would fail
    for axis in (None, one):
        assert csc_mod.selection_basis(norms, axis) is norms
    cfg = dataclasses.replace(_cfg(mode="csc", chunk_elems=512,
                                   warmup_steps=1, warmup_stages=1),
                              seq_len=16, global_batch=2)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.gf.model_axis is None
    state = trainer.init_state(0)
    seen, real = [], csc_mod.select_chunks
    vocab = cfg.model.vocab_size
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mock.patch.object(csc_mod, "select_chunks",
                           lambda b, k: (seen.append(b), real(b, k))[1]):
        for t in range(3):
            stage = trainer.gf.stage_for_step(t)
            norms = state.gf.chunk_norms
            state, _ = trainer.build_train_step(stage)(state, batch)
            if stage.num_selected < trainer.gf.num_chunks:
                assert seen.pop() is norms
    assert not seen and state.step == 3


def test_model_axis_refusals_after_construction(tmp_path):
    """A replan to another model degree still raises, naming ROADMAP.md
    A.23 (the JAX Trainer refuses it too); serving builds, under the
    serving rules; a window builds; a checkpoint manager in a process
    whose mesh has a model axis needs the trainer's layout."""
    trainer = Trainer(_cfg(), device="cpu", mesh=_fake_mesh())
    assert trainer.global_pool == 2 * trainer.pool.size
    assert trainer.num_chunks_global == 2 * trainer.gf.num_chunks
    step, rules = trainer.build_serve_step(serve_shape(t_base, B),
                                           mode="decode")
    assert step.model_axis.size == 2 and rules["serve_batch"] == ("data",)
    assert rules["kv_heads"] == "model" and rules["kv_seq"] is None
    with pytest.raises(ValueError, match="ROADMAP.md A.23"):
        trainer.replan(mesh=_fake_mesh(4))
    trainer.replan(mesh=_fake_mesh(2))  # the same model degree
    trainer.build_train_window(4)
    # Heads that the rules split but that do not split over the model
    # ranks (olmo-smoke shards 'qkv' and 'kv_heads').
    with pytest.raises(ValueError, match="KV heads"):
        Trainer(_cfg(), device="cpu", mesh=_fake_mesh(3))
    from repro_torch.checkpoint.manager import CheckpointManager
    layout = trainer.checkpoint_layout()
    assert (layout.model_size, layout.model_index, layout.num_data) == (
        2, 0, 1)
    assert layout.kind("opt/momentum") == "pool"
    assert layout.kind("gf/hg") == "row" and layout.kind("step") == \
        "replicated"
    assert Trainer(_cfg(), device="cpu").checkpoint_layout() is None
    collectives.set_data_group(LevelGroup(None, (0,), 0))
    try:
        with pytest.raises(ValueError, match="layout"):
            CheckpointManager(str(tmp_path))
        assert CheckpointManager(str(tmp_path), layout=layout).layout \
            is layout
    finally:
        collectives.set_data_group(None)


def test_serving_refuses_dimensions_that_do_not_split():
    """A cache of 13 positions split by position over 2 model ranks
    (qwen3-smoke's replicated KV heads put 'kv_seq' on 'model'), a batch
    of 3 over 2 data ranks, and the KV heads on 'model' with the
    positions forced there too: each refused by the dimension's logical
    axis when the step is built."""
    trainer = Trainer(_cfg("qwen3-32b"), device="cpu", mesh=_fake_mesh())
    odd = t_base.ShapeConfig(name="serve", seq_len=13, global_batch=2,
                             kind="decode")
    with pytest.raises(ValueError, match="'kv_seq' of size 13"):
        trainer.build_serve_step(odd, mode="decode")
    olmo = Trainer(_cfg(), device="cpu", mesh=_fake_mesh())
    with pytest.raises(ValueError, match="one mesh axis"):
        olmo.build_serve_step(serve_shape(t_base, 2), mode="decode",
                              kv_seq_shard="model")
    with pytest.raises(ValueError, match="only"):
        olmo.build_serve_step(serve_shape(t_base, 2), mode="decode",
                              kv_seq_shard=("data",))
    with mock.patch.object(Trainer, "_prepare_groups", lambda self, c: None):
        data2 = Trainer(_cfg(), device="cpu", mesh=t_mesh.Mesh(
            (2, 2), t_mesh.AXES, 0, LevelGroup(None, (0, 1), 0),
            LevelGroup(None, (0, 2), 0)))
    with pytest.raises(ValueError, match="'serve_batch' of size 3"):
        data2.build_serve_step(serve_shape(t_base, 3), mode="prefill")


@pytest.mark.parametrize("arch", ["smollm-135m", "arctic-480b", "grok-1-314b",
                                  "internvl2-26b", "musicgen-large",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_every_family_builds_under_a_model_axis(arch):
    """The head check reads the rule table: smollm-smoke's 3 query heads
    do not split over 2 ranks, but its rules shard no attention; the ssm
    family has no attention (falcon-mamba-smoke's one head)."""
    trainer = Trainer(_cfg(arch), device="cpu", mesh=_fake_mesh(2))
    assert trainer.global_pool == 2 * trainer.pool.size
    assert trainer.model_axis.size == 2

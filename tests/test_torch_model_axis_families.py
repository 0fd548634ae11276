"""The model axis for every family: the port at mesh (1, 2), two gloo
ranks, against the JAX package's Trainer.

One gloo group a family case (moe: arctic-smoke, whose rules shard the
experts, and grok1-smoke, whose rules shard each expert's hidden units;
vlm: internvl2-smoke; audio: musicgen-smoke; ssm: falcon-mamba-smoke;
hybrid: zamba2-smoke; and the head check that follows the rule table:
smollm-smoke, whose rules shard no attention, and stablelm-smoke cut to
one KV head, whose rules leave 'kv_heads' replicated, so each rank
gathers the KV projections). Every case starts from the same weights
(the port's initialiser, seed 0, cut with ``convert.shard_params``) and
the same seeded numpy batches. Against JAX's (1, 1):

* the loss and every leaf's gradient on the first batch, in f32
  (gathered with ``convert.unshard_params``; each leaf within 2e-5 of its
  largest magnitude), and every replicated leaf's gradient the same bits
  on both ranks (a missing model-group sum shows as ranks that differ);
* lazy training in f32 (losses within 2e-5 relative, the gathered final
  parameters within 2e-5 relative, as olmo-smoke's test holds them) and,
  for grok1-, musicgen- and zamba2-smoke, in bf16 compute (losses within
  JAX's own 6e-3 for that comparison, ``tests/test_distributed.py``);
* the train CLI at ``--mesh 1x2`` for grok1-, musicgen- and
  falcon-mamba-smoke (both ranks the same finite losses), and its
  refusal of the vlm by name;
* CSC for arctic-smoke and falcon-mamba-smoke, a dense warm-up step and
  three sparse ones. Against JAX's Trainer at (1, 2) on two placeholder
  devices (the data degree 1 of the port's run, because an MoE layer's
  capacity counts the tokens of one data shard in both packages) up to
  the first sparse update: the parameters after the warm-up, the losses
  through the first sparse step. From there the packages part by design:
  JAX selects each rank's chunks on its own pool, which holds its own
  copy of every replicated leaf, so its copies part after a sparse step
  (ROADMAP.md C.1); the port selects on the model group's summed norms.
  Each sparse step is held to that selection
  (``test_torch_model_axis.check_csc_steps``: the ranks' ids equal and
  ``repro.core.csc.select_chunks``' on the numpy sum of their norms, each
  rank's reduce ``repro.core.csc.csc_reduce``'s given that basis), and
  every replicated leaf is the same bits on both ranks after every step.

The JAX references run in two subprocesses (``repro.launch`` meshes need
their device count fixed at import) started with the ranks.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs.base import GradientFlowConfig
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.parallel.collectives import LevelGroup
from repro_torch.runtime import trace
from repro_torch.models import build_model
from test_torch_model_axis import (RULE_VARIANTS, _flat, _free_port, _tree,
                                   assert_replicas_equal, cache_leaves,
                                   check_csc_steps,
                                   check_serving, jax_serve, port_serve,
                                   record_csc, replicated_leaves, rules_json,
                                   save_jax_serve, serve_inputs, serve_shape)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
B, S = 2, 16
STEPS = 2
# CSC: step 0 the dense warm-up, steps 1-3 sparse.
CSC_STEPS = 4
RTOL, BF16_RTOL = 2e-5, 6e-3
KV1 = "stablelm-12b:kv1"  # stablelm-smoke with one KV head
GROUPS = {"moe": ("arctic-480b", "grok-1-314b"), "vlm": ("internvl2-26b",),
          "audio": ("musicgen-large",), "ssm": ("falcon-mamba-7b",),
          "hybrid": ("zamba2-2.7b",), "heads": ("smollm-135m", KV1)}
FAMILY_ARCHS = ("arctic-480b", "grok-1-314b", "internvl2-26b",
                "musicgen-large", "falcon-mamba-7b", "zamba2-2.7b")
TRAINED = FAMILY_ARCHS + ("smollm-135m",)
CSC_ARCHS = ("arctic-480b", "falcon-mamba-7b")
# bf16: the sharded sums that round otherwise in bf16: grok's expert
# hidden units, musicgen's K vocab-parallel heads, zamba2's gathered
# Mamba-2 projections and its norm's sum of squares.
BF16_ARCHS = ("grok-1-314b", "musicgen-large", "zamba2-2.7b")
# The train CLI at --mesh 1x2 (the vlm stays refused by name there).
CLI_ARCHS = ("grok-1-314b", "musicgen-large", "falcon-mamba-7b")
# The serve CLI at --mesh 1x2 in f32: an attention family whose cache is
# split by position under sharded heads, and the ssm family.
SERVE_CLI_ARCHS = ("grok-1-314b", "falcon-mamba-7b")
SERVE_CLI_ARGV = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen",
                  "4", "--seed", "3", "--device", "cpu"]
ALL = FAMILY_ARCHS + ("smollm-135m", KV1)


def _gf(mode):
    # CSC: step 0 is the dense warm-up, step 1 the sparse stage.
    return dict(mode=mode, bucket_elems=8192, chunk_elems=512, sparsity=0.5,
                warmup_steps=1 if mode == "csc" else 0, warmup_stages=1,
                wire_dtype="float32")


OPT = dict(name="momentum_sgd", learning_rate=0.2, warmup_steps=1,
           total_steps=20, schedule="constant")


def _model(case, f32):
    arch, _, variant = case.partition(":")
    cfg = get_smoke(arch)[0]
    if variant == "kv1":
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    return dataclasses.replace(cfg, compute_dtype="float32") if f32 else cfg


def _rules(case):
    return get_smoke(case.partition(":")[0])[1]


def _tag(case):
    return case.replace(":", "_")


def _specs(case):
    return build_model(_model(case, True)).param_specs()


def _inputs(case):
    """{'p/<leaf>': the initial weights, 'b<t>/<key>': batch t}: the
    port's initialiser at seed 0 and numpy batches from one seed; the
    vlm's vision embeddings bf16 values (both packages cast them)."""
    import torch
    cfg = _model(case, True)
    params = build_model(cfg).init_params(0, torch.device("cpu"))
    out = {f"p/{k}": v for k, v in _flat(convert.params_to_numpy(params))
           .items()}
    rng = np.random.default_rng(0)
    for t in range(CSC_STEPS):
        shape = (B, S + 1) + ((cfg.num_codebooks,)
                              if cfg.family == "audio" else ())
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out[f"b{t}/tokens"], out[f"b{t}/labels"] = toks[:, :-1], toks[:, 1:]
        if cfg.family == "vlm":
            vis = rng.standard_normal((B, cfg.num_vision_tokens,
                                       cfg.d_model)).astype(np.float32)
            out[f"b{t}/vision_embeds"] = torch.from_numpy(vis).to(
                torch.bfloat16).float().numpy()
    out.update(serve_inputs(cfg, B))
    return out


def _batch(inputs, t):
    return {k.split("/", 1)[1]: v for k, v in inputs.items()
            if k.startswith(f"b{t}/")}


# -- the JAX side (imported in the functions: the ranks load no JAX) ----------


def _jax_trainer(case, mode, f32, mesh_shape):
    from repro.configs.base import GradientFlowConfig as JGF
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import TrainConfig as JTrain
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.launch.trainer import Trainer as JTrainer

    cfg = JTrain(model=_model(case, f32), gradientflow=JGF(**_gf(mode)),
                 optimizer=JOpt(**OPT), seq_len=S, global_batch=B,
                 attn_chunk=0)
    return JTrainer(cfg, j_make_mesh(mesh_shape, ("data", "model")),
                    _rules(case))


def _jax_batch(b):
    import jax.numpy as jnp
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype.kind == "f"
                           else jnp.int32) for k, v in b.items()}


def jax_train(case, mode, f32, mesh_shape, inputs, steps, snap=None):
    """(losses, parameters {leaf: array} after ``snap`` steps (default:
    the last)) of JAX's Trainer from the inputs' weights on their
    batches. ``init_state`` takes the inputs' weights in place of its
    initialiser's draw (which compiles a program a leaf shape: ~3-4 s a
    Trainer on the CPU)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import repro.launch.trainer as j_trainer_mod
    from repro.parallel.collectives import compat_set_mesh

    trainer = _jax_trainer(case, mode, f32, mesh_shape)
    params = _tree(trainer.specs, {k[2:]: jnp.asarray(v)
                                   for k, v in inputs.items()
                                   if k.startswith("p/")})
    losses, fns = [], {}
    with compat_set_mesh(trainer.mesh), mock.patch.object(
            j_trainer_mod.sh, "init_params",
            lambda specs, key, dtype=None: params):
        state = trainer.init_state(jax.random.PRNGKey(0))
        for t in range(steps):
            stage = trainer.gf.stage_for_step(t)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage,
                                                            donate=False)
            state, m = fns[stage.index](state, jax.device_put(
                _jax_batch(_batch(inputs, t))))
            losses.append(float(m["loss"]))
            if t + 1 == (snap or steps):
                out = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    return losses, out


def jax_grads(case, inputs):
    """(total loss, {leaf: gradient}) of JAX's model on batch 0 in f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as j_build

    model = j_build(_model(case, True))
    specs = model.param_specs()
    params = _tree(specs, {k[2:]: jnp.asarray(v) for k, v in inputs.items()
                           if k.startswith("p/")})
    batch = _jax_batch(_batch(inputs, 0))
    fn = jax.jit(jax.value_and_grad(lambda p: model.loss_fn(
        p, batch, compute_dtype=jnp.float32)[0]))
    loss, grads = fn(params)
    return float(loss), _flat(jax.tree_util.tree_map(np.asarray, grads))


def jax_serve_refs(case, inputs):
    """JAX's serving of ``case`` in f32: ``build_serve_step``'s values at
    (1, 1) (``jax_serve``), and at (1, 2) on two placeholder devices the
    rules of each of RULE_VARIANTS and the shard shape of each cache
    leaf in ``abstract_serve_args``."""
    import jax
    from jax._src.named_sharding import DuplicateSpecError
    from repro.configs import base as j_base
    from repro.parallel.collectives import compat_set_mesh

    out = {}
    trainer = _jax_trainer(case, "lazy", True, (1, 1))
    params = _tree(trainer.specs, {k[2:]: v for k, v in inputs.items()
                                   if k.startswith("p/")})
    with compat_set_mesh(trainer.mesh):
        save_jax_serve(jax_serve(trainer, params, inputs, B), "serve", out)
    trainer = _jax_trainer(case, "lazy", True, (1, 2))
    sc = serve_shape(j_base, B)
    with compat_set_mesh(trainer.mesh):
        for v, (mode, flash, kv) in enumerate(RULE_VARIANTS):
            try:  # 'model' on two cache dimensions: a PartitionSpec error
                out[f"serve/variant{v}"] = np.asarray(rules_json(
                    trainer.build_serve_step(sc, mode=mode, kv_seq_shard=kv,
                                             flash_decode=flash)[1]))
            except DuplicateSpecError:
                out[f"serve/variant{v}"] = np.asarray("refused")
        rules = trainer.build_serve_step(sc, mode="decode")[1]
        cache = trainer.abstract_serve_args(sc, rules, "decode")[2]
        for j, leaf in enumerate(jax.tree_util.tree_leaves(tuple(cache))):
            out[f"serve/shard{j}"] = np.asarray(
                leaf.sharding.shard_shape(leaf.shape))
    return out


def jax_refs(tmp, cases):
    """Every JAX reference of ``cases`` [(case, what)], one npz each."""
    for case, what in cases:
        inputs = dict(np.load(os.path.join(tmp, f"in_{_tag(case)}.npz")))
        if what == "serve":
            out = jax_serve_refs(case, inputs)
        elif what == "grad":
            loss, grads = jax_grads(case, inputs)
            out = dict(loss=np.asarray(loss),
                       **{f"g/{k}": v for k, v in grads.items()})
        else:
            mode, f32, mesh_shape, steps, snap = {
                "lazy32": ("lazy", True, (1, 1), STEPS, None),
                "lazy16": ("lazy", False, (1, 1), STEPS, None),
                # Through the first sparse step; the warm-up's params.
                "csc": ("csc", True, (1, 2), 2, 1)}[what]
            losses, final = jax_train(case, mode, f32, mesh_shape, inputs,
                                      steps, snap)
            out = dict(losses=np.asarray(losses),
                       **{f"p/{k}": v for k, v in final.items()})
        np.savez(os.path.join(tmp, f"jax_{_tag(case)}_{what}.npz"), **out)


def _jax_jobs(n=2):
    """The JAX references dealt out to ``n`` subprocesses, the costliest
    first (CSC on two devices, then the Trainer runs, then gradients)."""
    jobs = [(c, "csc") for c in CSC_ARCHS] \
        + [(c, "lazy32") for c in TRAINED] \
        + [(c, "lazy16") for c in BF16_ARCHS] + [(c, "serve") for c in ALL] \
        + [(c, "grad") for c in ALL]
    return [jobs[i::n] for i in range(n)]


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path[:0] = [{tests!r}, {src!r}]
from test_torch_model_axis_families import jax_refs
jax_refs({tmp!r}, {jobs!r})
"""


# -- the port's ranks ---------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import torch, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, port, group, tmp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=2, rank=rank)
    from test_torch_model_axis_families import rank_main
    rank_main(rank, group, tmp)
    dist.destroy_process_group()
""")


def port_trainer(case, mode, f32, mesh):
    cfg = TrainConfig(model=_model(case, f32),
                      gradientflow=GradientFlowConfig(**_gf(mode),
                                                      use_kernels=True),
                      optimizer=OptimizerConfig(**OPT), seq_len=S,
                      global_batch=B, attn_chunk=0)
    return Trainer(cfg, device="cpu", mesh=mesh)


def _torch_batch(b):
    import torch
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v).to(torch.bfloat16) for k, v in b.items()}


def rank_main(rank, group, tmp):
    """One rank of a group's cases: the gradient on batch 0, lazy f32 and
    bf16 training, CSC where named; saves the local leaves."""
    mesh = t_mesh.make_mesh((1, 2))
    for case in GROUPS[group]:
        inputs = dict(np.load(os.path.join(tmp, f"in_{_tag(case)}.npz")))
        specs = _specs(case)
        full = _tree(specs, {k[2:]: v for k, v in inputs.items()
                             if k.startswith("p/")})
        saved = {}
        runs = [("lazy32", "lazy", True, STEPS)] * (case in TRAINED) + [
            ("lazy16", "lazy", False, STEPS)] * (case in BF16_ARCHS) + [
            ("csc", "csc", True, CSC_STEPS)] * (case in CSC_ARCHS)
        for what, mode, f32, steps in [("grad", "lazy", True, 0)] + runs:
            before = trace.counters["model_axis"]["all_reduces"]
            trainer = port_trainer(case, mode, f32, mesh)
            local = convert.params_from_numpy(convert.shard_params(
                full, trainer.rules, 2, mesh.model_index,
                specs=trainer.specs), "cpu")
            if what == "grad":
                grads, m = trainer._value_and_grad(
                    trainer.pool.flat_leaves(local),
                    _torch_batch(_batch(inputs, 0)))
                saved["grad/loss"] = np.asarray(float(m["loss"])
                                                + float(m["aux_loss"]))
                for k, v in _flat(convert.params_to_numpy(
                        trainer.pool.unflatten(grads))).items():
                    saved[f"grad/g/{k}"] = v
                continue
            state = trainer.init_state(params=local)
            fns, losses, recs = {}, [], []
            rep = replicated_leaves(trainer)
            with record_csc(recs) if mode == "csc" \
                    else contextlib.nullcontext():
                for t in range(steps):
                    stage = trainer.gf.stage_for_step(t)
                    if stage.index not in fns:
                        fns[stage.index] = trainer.build_train_step(stage)
                    state, m = fns[stage.index](
                        state, _torch_batch(_batch(inputs, t)))
                    losses.append(float(m["loss"]))
                    # Copies: the state's tensors are updated in place.
                    flat = {k: v.copy() for k, v in _flat(
                        convert.params_to_numpy(state.params)).items()}
                    for k in rep:
                        saved[f"{what}/rep{t}/{k}"] = flat[k]
                    if mode == "csc" and t == 0:  # the warm-up's
                        for k, v in flat.items():
                            saved[f"{what}/snap/{k}"] = v
            for i, r in enumerate(recs):
                saved.update({f"csc/s{i}/{k}": v for k, v in r.items()})
            saved[f"{what}/losses"] = np.asarray(losses)
            saved[f"{what}/all_reduces"] = np.asarray(
                trace.counters["model_axis"]["all_reduces"] - before)
            for k, v in _flat(convert.params_to_numpy(state.params)).items():
                saved[f"{what}/p/{k}"] = v
        # Serving from the same weights (f32): each call's logits and
        # cache blocks, the all-reduces, the rules.
        trainer = port_trainer(case, "lazy", True, mesh)
        local = convert.params_from_numpy(convert.shard_params(
            full, trainer.rules, 2, mesh.model_index, specs=trainer.specs),
            "cpu")
        port_serve(trainer, local, inputs, B, saved, "serve")
        if case in SERVE_CLI_ARCHS:
            saved["serve_cli"] = serve_cli_f32(
                ["--arch", case, "--mesh", "1x2"] + SERVE_CLI_ARGV).numpy()
        if case in CLI_ARCHS:
            from repro_torch.launch import train
            saved["cli_losses"] = np.asarray(train.main(
                ["--arch", case, "--reduced", "--mesh", "1x2", "--steps",
                 "2", "--batch", "2", "--seq-len", str(S), "--gf-mode",
                 "lazy", "--window-steps", "1", "--device", "cpu"]))
        if case == "internvl2-26b":
            from repro_torch.launch import train
            try:
                train.main(["--arch", case, "--reduced", "--mesh", "1x2",
                            "--steps", "1", "--window-steps", "1",
                            "--device", "cpu"])
                raise AssertionError("the CLI trained the vlm")
            except ValueError as e:
                assert "vision_embeds" in str(e), e
        np.savez(os.path.join(tmp, f"port_{_tag(case)}_{rank}.npz"), **saved)


def serve_cli_f32(argv):
    """``launch.serve.main(argv)`` with the smoke configuration in f32
    compute, the weights and the cache kept in f32 (the CLI's own are
    bf16)."""
    import torch

    from repro_torch.launch import serve

    real, cache = serve.get_smoke, Trainer.init_serve_cache

    def f32(arch):
        cfg, rules = real(arch)
        return dataclasses.replace(cfg, compute_dtype="float32"), rules
    with mock.patch.object(serve, "get_smoke", f32), mock.patch.object(
            serve, "serve_params", lambda model, seed, dev:
            model.init_params(seed, dev, on_device=True)), \
            mock.patch.object(Trainer, "init_serve_cache",
                              lambda self, shape, rules, dtype=None:
                              cache(self, shape, rules, torch.float32)):
        return serve.main(argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write every case's inputs, start the two JAX subprocesses and one
    gloo group of two ranks a family case, then collect everything:
    {case: (JAX {what: npz}, [rank 0's npz, rank 1's])}."""
    tmp = str(tmp_path_factory.mktemp("model_axis_families"))
    for case in ALL:
        np.savez(os.path.join(tmp, f"in_{_tag(case)}.npz"), **_inputs(case))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX.format(tests=TESTS, src=SRC, tmp=tmp,
                                           jobs=jobs)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for jobs in _jax_jobs()]
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER.format(tests=TESTS, src=SRC))
    for group in GROUPS:
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, script, str(r), port,
                                    group, tmp], env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
                  for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, (out[-2000:], err[-4000:])
    res = {}
    for case in ALL:
        ref = {}
        for what in ("grad", "lazy32", "lazy16", "csc", "serve"):
            path = os.path.join(tmp, f"jax_{_tag(case)}_{what}.npz")
            if os.path.exists(path):
                ref[what] = dict(np.load(path))
        res[case] = (ref, [dict(np.load(os.path.join(
            tmp, f"port_{_tag(case)}_{r}.npz"))) for r in range(2)])
    return res


def _gathered(case, parts, prefix):
    """The global tree of both ranks' ``prefix`` leaves, flat."""
    specs = _specs(case)
    local = [_tree(specs, {k[len(prefix):]: v for k, v in p.items()
                           if k.startswith(prefix)}) for p in parts]
    return _flat(convert.unshard_params(local, _rules(case), specs=specs))


def _replicated(case):
    from repro_torch.parallel import sharding
    return [k for k, s in _flat_specs(_specs(case)).items()
            if sharding.model_dim(s, _rules(case)) is None]


def _flat_specs(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat_specs(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("case", ALL)
def test_gradients_at_1x2_match_jax(runs, case):
    ref, ranks = runs[case]
    want = ref["grad"]
    for r in ranks:
        np.testing.assert_allclose(r["grad/loss"], want["loss"], rtol=RTOL)
    # Each replicated leaf's gradient is the whole batch's on both ranks,
    # bit for bit: the model-group sums of its partial terms are done.
    rep = _replicated(case)
    assert rep, case
    for name in rep:
        np.testing.assert_array_equal(ranks[0][f"grad/g/{name}"],
                                      ranks[1][f"grad/g/{name}"],
                                      err_msg=name)
    got = _gathered(case, ranks, "grad/g/")
    assert got.keys() == {k[2:] for k in want if k.startswith("g/")}
    for name, g in got.items():
        w = want[f"g/{name}"]
        scale = np.abs(w).max()
        if scale == 0:  # the audio family's unused 'tokens' table
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        err = np.abs(g - w).max() / scale
        assert err <= RTOL, (name, err)


@pytest.mark.parametrize("case", TRAINED)
def test_lazy_f32_at_1x2_matches_jax(runs, case):
    ref, ranks = runs[case]
    want = ref["lazy32"]
    for r in ranks:
        np.testing.assert_allclose(r["lazy32/losses"], want["losses"],
                                   rtol=RTOL)
        assert r["lazy32/all_reduces"] > 0
    got = _gathered(case, ranks, "lazy32/p/")
    for name, g in got.items():
        np.testing.assert_allclose(g, want[f"p/{name}"], rtol=RTOL,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", BF16_ARCHS)
def test_lazy_bf16_at_1x2_matches_jax(runs, case):
    ref, ranks = runs[case]
    for r in ranks:
        np.testing.assert_allclose(r["lazy16/losses"],
                                   ref["lazy16"]["losses"], rtol=BF16_RTOL)
    np.testing.assert_array_equal(ranks[0]["lazy16/losses"],
                                  ranks[1]["lazy16/losses"])


@pytest.mark.parametrize("case", CSC_ARCHS)
def test_csc_at_1x2_matches_jax_1x2(runs, case):
    ref, ranks = runs[case]
    want = ref["csc"]
    for r in ranks:
        # JAX's (1, 2) Trainer through the first sparse step.
        np.testing.assert_allclose(r["csc/losses"][:2], want["losses"],
                                   rtol=RTOL)
        assert r["csc/losses"].shape == (CSC_STEPS,)
        assert np.isfinite(r["csc/losses"]).all()
    got = _gathered(case, ranks, "csc/snap/")
    for name, g in got.items():
        np.testing.assert_allclose(g, want[f"p/{name}"], rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    # Then the summed selection, three sparse steps: the ids, the
    # reduce, and the replicated leaves equal across the ranks (C.1).
    check_csc_steps(ranks, [(0, 1)], [(0,), (1,)], 512, CSC_STEPS - 1)
    assert assert_replicas_equal(ranks, [(0, 1)], "csc") \
        == CSC_STEPS * len(_replicated(case))


@pytest.mark.parametrize("case", CLI_ARCHS)
def test_cli_at_mesh_1x2_trains(runs, case):
    ranks = runs[case][1]
    losses = ranks[0]["cli_losses"]
    assert losses.shape == (2,) and np.isfinite(losses).all()
    np.testing.assert_array_equal(losses, ranks[1]["cli_losses"])


@pytest.mark.parametrize("case", ALL)
def test_serving_at_1x2_matches_jax(runs, case):
    """The case served by two ranks at mesh (1, 2), f32, against JAX's
    (1, 1) ``build_serve_step`` (``check_serving``): a prefill and four
    decode steps, naive and ``split_combine``; the cache's KV heads split
    over 'model' (musicgen, zamba2's shared block), its positions
    ('kv_seq') with the heads sharded (grok1, internvl2, one-KV-head
    stablelm) or attention replicated (smollm, arctic), the Mamba states
    on the rank's channels or heads."""
    ref, ranks = runs[case]
    check_serving(ref["serve"], ranks, "serve", _model(case, True), (1, 2),
                  B)


@pytest.mark.parametrize("case", ALL)
def test_serve_rules_and_layouts_at_1x2_match_jax(runs, case):
    """The rules ``build_serve_step`` returns (prefill; decode with and
    without ``flash_decode`` and ``kv_seq_shard='model'``) equal JAX's
    Trainer's at (1, 2); both refuse the variants that put 'model' on two
    cache dimensions (``kv_seq_shard='model'`` where the KV heads are on
    it), the rest build; each cache block's shape is JAX's
    ``shard_shape``."""
    ref, ranks = runs[case]
    want = ref["serve"]
    for r in ranks:
        for v in range(len(RULE_VARIANTS)):
            refused = str(want[f"serve/variant{v}"]) == "refused"
            assert bool(r[f"serve/variant{v}/built"]) == (not refused), v
            if not refused:
                got = str(r[f"serve/variant{v}"])
                assert got == str(want[f"serve/variant{v}"]), (case, v, got)
        shards = sorted(k for k in want if k.startswith("serve/shard"))
        for j in range(len(shards)):
            assert tuple(r[f"serve/0/c0/{j}"].shape) == tuple(
                want[f"serve/shard{j}"]), (case, j)


@pytest.mark.parametrize("case", SERVE_CLI_ARCHS)
def test_serve_cli_at_mesh_1x2_equals_1x1(runs, case):
    """``python -m repro_torch.launch.serve --mesh 1x2`` (two gloo ranks,
    f32): both ranks return the same tokens, the tokens of the one-process
    run."""
    ranks = runs[case][1]
    np.testing.assert_array_equal(ranks[0]["serve_cli"],
                                  ranks[1]["serve_cli"])
    want = serve_cli_f32(["--arch", case] + SERVE_CLI_ARGV)
    np.testing.assert_array_equal(ranks[0]["serve_cli"], want.numpy())


# -- the serving layouts against JAX's shard shapes (no process) -------------

LAYOUT_MESHES = ((1, 2), (2, 2), (2, 1))


def _axes_fields(axes):
    """A cache's logical axes, field by field, nested NamedTuples
    flattened (the axes themselves are tuples of names)."""
    if hasattr(axes, "_fields"):
        return [(f,) + x for f, a in zip(axes._fields, axes)
                for x in _axes_fields(a)]
    return [(axes,)]


def _spec_shapes(tree, prefix=""):
    """{leaf path: shape} of the port's (shape, dtype) parameter tree."""
    out = {}
    for k, v in tree.items():
        out.update(_spec_shapes(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": tuple(v[0])})
    return out


def jax_serve_layout(case, mesh_shape, batch, mode):
    """(rules, {param path: shard shape}, {batch key: shard shape}, [(cache
    leaf shard shape, dtype name)]) of JAX's ``Trainer.serve_rules`` /
    ``build_serve_step`` / ``abstract_serve_args`` on an abstract mesh of
    ``mesh_shape``: the methods run on a stand-in holding the attributes
    they read (the Trainer's own constructor needs the devices)."""
    import types

    import jax
    from jax.sharding import AbstractMesh
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.launch.trainer import Trainer as JTrainer
    from repro.models import build_model as j_build
    from repro.parallel import sharding as j_sh

    cfg = JTrain(model=_model(case, True), seq_len=12, global_batch=batch)
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    t = types.SimpleNamespace(
        cfg=cfg, mesh=mesh, rules=dict(_rules(case)),
        model=j_build(cfg.model), model_size=mesh_shape[1],
        data_axes=("data",), num_data=mesh_shape[0])
    t.specs = t.model.param_specs()
    t.param_shardings = j_sh.param_shardings(t.specs, mesh, t.rules)
    t.serve_rules = lambda long_context=False: JTrainer.serve_rules(
        t, long_context)
    t.batch_pspec = lambda tree: JTrainer.batch_pspec(t, tree)
    sc = JShape(name="serve", seq_len=12, global_batch=batch, kind="decode")
    rules = JTrainer.build_serve_step(t, sc, mode=mode)[1]
    params, b, cache = JTrainer.abstract_serve_args(t, sc, rules, mode)

    def shard(leaf):
        return tuple(leaf.sharding.shard_shape(leaf.shape))
    return (rules,
            {"/".join(k.key for k in path): shard(leaf) for path, leaf in
             jax.tree_util.tree_leaves_with_path(params)},
            {k: shard(v) for k, v in b.items()},
            [(shard(x), str(x.dtype))
             for x in jax.tree_util.tree_leaves(tuple(cache))])


def _layout_mesh(shape):
    """A stand-in mesh of ``shape`` at rank 0 (no process group)."""
    d, m = shape
    return t_mesh.Mesh(shape, t_mesh.AXES, 0,
                       LevelGroup(None, tuple(range(m)), 0),
                       LevelGroup(None, tuple(range(0, d * m, m)), 0))


@pytest.mark.parametrize("case", ALL)
def test_serving_layouts_match_jax_shard_shapes(case):
    """Every family's ``cache_logical_axes`` equals JAX's, and at meshes
    (1, 2), (2, 2) and (2, 1), at batch 4 and 1 (long context where the
    data degree is 2), prefill and decode: ``serve_rules`` as
    ``build_serve_step`` returns them, and each leaf of
    ``abstract_serve_args`` (the bf16 parameter blocks, the batch, the
    cache) JAX's ``NamedSharding.shard_shape``."""
    from repro.models import build_model as j_build
    from repro_torch.configs.base import ShapeConfig

    cfg = _model(case, True)
    assert _axes_fields(build_model(cfg).cache_logical_axes()) == \
        _axes_fields(j_build(cfg).cache_logical_axes())
    for shape in LAYOUT_MESHES:
        # A stand-in mesh has no groups to lay the data topology over.
        with mock.patch.object(Trainer, "_prepare_groups",
                               lambda self, gf_cfg: None):
            trainer = Trainer(TrainConfig(model=cfg, seq_len=12,
                                          global_batch=4),
                              device="cpu", mesh=_layout_mesh(shape))
        for batch in (4, 1):
            sc = ShapeConfig(name="serve", seq_len=12, global_batch=batch,
                             kind="decode")
            for mode in ("prefill", "decode"):
                rules, params, b, cache = jax_serve_layout(case, shape,
                                                           batch, mode)
                got = trainer.serve_step_rules(sc, mode=mode)
                assert rules_json(got) == rules_json(rules), (shape, batch)
                p, tb, tc = trainer.abstract_serve_args(sc, got, mode)
                assert _spec_shapes(p) == params, (shape, batch, mode)
                assert {k: tuple(v[0]) for k, v in tb.items()} == b
                assert [(tuple(x[0]), str(x[1]).split(".")[-1])
                        for x in cache_leaves(tc)] == cache, (
                    shape, batch, mode)

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

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs.base import GradientFlowConfig
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.models import build_model
from test_torch_model_axis import (_flat, _free_port, _tree,
                                   assert_replicas_equal, check_csc_steps,
                                   record_csc, replicated_leaves)

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


def jax_refs(tmp, cases):
    """Every JAX reference of ``cases`` [(case, what)], one npz each."""
    for case, what in cases:
        inputs = dict(np.load(os.path.join(tmp, f"in_{_tag(case)}.npz")))
        if what == "grad":
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
        + [(c, "lazy16") for c in BF16_ARCHS] + [(c, "grad") for c in ALL]
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
                trainer.model_axis.stats["all_reduces"])
            for k, v in _flat(convert.params_to_numpy(state.params)).items():
                saved[f"{what}/p/{k}"] = v
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
        for what in ("grad", "lazy32", "lazy16", "csc"):
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

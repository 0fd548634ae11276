"""The model axis (tensor parallelism) of the port against the JAX
package's Trainer.

* Four gloo ranks at mesh (2, 2) train olmo-smoke (tied, vocab-parallel
  embedding and head) in f32 compute on an f32 wire, 4 steps each in
  dense, lazy and CSC, from the JAX Trainer's initial weights cut with
  ``convert.shard_params``. Dense and lazy: the losses and the
  parameters gathered with ``convert.unshard_params`` equal JAX's (1, 1)
  Trainer within 2e-5 relative (the row-parallel sums and the
  vocab-parallel log-sum-exp add in another order). CSC selects its
  chunks per model rank, on each rank's local pool (its two sparse
  steps), so its reference is JAX's own (2, 2) Trainer, on four
  placeholder devices in a subprocess, within the same bound.
* Two gloo ranks at mesh (1, 2) train qwen3-smoke (GQA, 8 query and 2
  KV heads, QK-norm, the replicated-KV rule) lazy in bf16 compute: the
  losses within JAX's own bound for the same comparison, rtol 6e-3
  (``tests/test_distributed.py``). The same ranks run the train CLI at
  ``--mesh 1x2`` and check its refusals.
* On every rank the replicated leaves (norm weights, QK-norm scales)
  end bit for bit equal across the model ranks.
* In one process: every combination the port does not run under a
  model axis raises, naming ROADMAP.md A.23, for every family; heads
  that the rules split but that do not split over the model ranks
  raise.

The spawns and the JAX subprocess start together (``runs``) and the JAX
(1, 1) references are computed while they run.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs.base import GradientFlowConfig, GuardConfig
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.models import build_model
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import LevelGroup
from repro_torch.parallel.topology import Topology

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
STEPS, B, S = 4, 4, 32
MODES = ("dense", "lazy", "csc")
RTOL = 2e-5


def _gf(mode):
    # CSC: a dense warm-up stage for steps 0-1, then the sparse stage.
    return dict(mode=mode, bucket_elems=4096, chunk_elems=512, sparsity=0.5,
                warmup_steps=2 if mode == "csc" else 0, warmup_stages=1,
                wire_dtype="float32")


OPT = dict(name="momentum_sgd", learning_rate=0.2, warmup_steps=1,
           total_steps=20, schedule="constant")


def _model(arch, f32):
    cfg = get_smoke(arch)[0]
    return dataclasses.replace(cfg, compute_dtype="float32") if f32 else cfg


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


def jax_run(arch, mode, f32, mesh_shape=(1, 1), params=None, steps=STEPS):
    """(losses, final params as numpy, initial params) of JAX's Trainer
    (``steps`` 0: only the initial parameters)."""
    import jax
    from repro.configs import get_smoke as j_get_smoke
    from repro.configs.base import GradientFlowConfig as JGF
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import TrainConfig as JTrain
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.launch.trainer import Trainer as JTrainer
    from repro.parallel.collectives import compat_set_mesh

    cfg = JTrain(model=_model(arch, f32), gradientflow=JGF(**_gf(mode)),
                 optimizer=JOpt(**OPT), seq_len=S, global_batch=B,
                 attn_chunk=0)
    mesh = j_make_mesh(mesh_shape, ("data", "model"))
    trainer = JTrainer(cfg, mesh, j_get_smoke(arch)[1])
    data = SyntheticLM(cfg.model.vocab_size, seed=0)
    losses, fns = [], {}
    with compat_set_mesh(mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        if params is not None:  # {leaf path: array}
            state = state._replace(params=jax.tree_util.tree_map_with_path(
                lambda path, s: jax.device_put(
                    params["/".join(k.key for k in path)], s),
                trainer.param_shardings))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        for t in range(steps):
            stage = trainer.gf.stage_for_step(t)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage,
                                                            donate=False)
            state, m = fns[stage.index](state, jax.device_put(
                data.batch(t, B, S)))
            losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params), init


def batches(vocab):
    from repro.data.synthetic import SyntheticLM
    data = SyntheticLM(vocab, seed=0)
    return {f"{k}{t}": np.asarray(v) for t in range(STEPS)
            for k, v in data.batch(t, B, S).items()}


_JAX_22 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{tests!r}, {src!r}]
import numpy as np
from test_torch_model_axis import jax_run, _flat
params = dict(np.load({weights!r}))
losses, final, _ = jax_run("olmo-1b", "csc", True, (2, 2), params)
np.savez({out!r}, losses=np.asarray(losses), **_flat(final))
"""


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
    cfg = TrainConfig(model=_model(arch, f32),
                      gradientflow=GradientFlowConfig(
                          **_gf(mode), use_kernels=use_kernels),
                      optimizer=OptimizerConfig(**OPT), seq_len=S,
                      global_batch=B, attn_chunk=0)
    return Trainer(cfg, device="cpu", mesh=mesh)


def rank_main(rank, world, out):
    """One rank of the (2, 2) olmo run (world 4) or of the (1, 2) qwen3
    run and CLI check (world 2); saves losses and local parameters."""
    import torch
    mesh = t_mesh.make_mesh((2, 2) if world == 4 else (1, 2))
    arch, f32, modes = ("olmo-1b", True, MODES) if world == 4 \
        else ("qwen3-32b", False, ("lazy",))
    inputs = dict(np.load(os.path.join(os.path.dirname(out),
                                       f"{arch}_inputs.npz")))
    full = _tree(_specs(arch), {k[2:]: v for k, v in inputs.items()
                                if k.startswith("p/")})
    rows = slice(mesh.data_index * B // mesh.num_data,
                 (mesh.data_index + 1) * B // mesh.num_data)
    saved = {}
    for mode in modes:
        trainer = port_trainer(arch, mode, f32, mesh)
        local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                     mesh.model_index, specs=trainer.specs)
        state = trainer.init_state(params=convert.params_from_numpy(
            local, "cpu"))
        steps = {}
        losses = []
        for t in range(STEPS):
            stage = trainer.gf.stage_for_step(t)
            if stage.index not in steps:
                steps[stage.index] = trainer.build_train_step(stage)
            batch = {k: torch.from_numpy(inputs[f"{k}{t}"][rows])
                     for k in ("tokens", "labels")}
            state, m = steps[stage.index](state, batch)
            losses.append(float(m["loss"]))
        saved[f"{mode}/losses"] = np.asarray(losses)
        for name, v in _flat(convert.params_to_numpy(state.params)).items():
            saved[f"{mode}/p/{name}"] = v
        saved[f"{mode}/all_reduces"] = np.asarray(
            trainer.model_axis.stats["all_reduces"])
        saved[f"{mode}/pool"] = np.asarray(
            [trainer.pool.size, trainer.global_pool])
    if world == 2:
        from repro_torch.launch import train
        args = ["--arch", "qwen3-32b", "--reduced", "--mesh", "1x2",
                "--steps", "2", "--batch", "2", "--seq-len", "32",
                "--gf-mode", "lazy", "--device", "cpu"]
        for extra, what in ((["--window-steps", "8"], "window"),
                            (["--window-steps", "1", "--ckpt-dir", out],
                             "ckpt-dir")):
            try:
                train.parse_args(args + extra)
                raise AssertionError(what)
            except ValueError as e:
                assert "ROADMAP.md A.23" in str(e), e
        losses = train.main(args + ["--window-steps", "1"])
        saved["cli_losses"] = np.asarray(losses)
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
    JAX (2, 2) CSC subprocess and both spawns, compute the JAX (1, 1)
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
                 **{f"p/{k}": v for k, v in init.items()})
    jax22 = subprocess.Popen(
        [sys.executable, "-c", _JAX_22.format(
            tests=tests, src=SRC, weights=str(tmp / "olmo_init.npz"),
            out=str(tmp / "jax22.npz"))],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(tests=tests, src=SRC))
    procs = _spawn(script, 4, tmp) + _spawn(script, 2, tmp)
    for arch, mode, f32 in (("olmo-1b", "dense", True),
                            ("olmo-1b", "lazy", True),
                            ("qwen3-32b", "lazy", False)):
        ref[(arch, mode)] = jax_run(arch, mode, f32)[:2]
    _wait(procs)
    _wait([jax22])
    j22 = dict(np.load(tmp / "jax22.npz"))
    ref[("olmo-1b", "csc")] = (list(j22.pop("losses")),
                               _tree(_specs("olmo-1b"), j22))
    ranks = {w: [dict(np.load(tmp / f"w{w}_rank{r}.npz")) for r in range(w)]
             for w in (4, 2)}
    return ref, ranks


def _gathered(parts, mode, arch):
    specs = _specs(arch)
    local = [_tree(specs, {k[len(mode) + 3:]: v for k, v in p.items()
                           if k.startswith(f"{mode}/p/")}) for p in parts]
    return convert.unshard_params(local, get_smoke(arch)[1], specs=specs)


def _assert_params(got, want, rtol, atol, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("mode", MODES)
def test_mesh_2x2_matches_jax(runs, mode):
    ref, ranks = runs
    want_losses, want_params = ref[("olmo-1b", mode)]
    r = ranks[4]
    for p in r:
        np.testing.assert_allclose(p[f"{mode}/losses"], want_losses,
                                   rtol=RTOL, err_msg=mode)
        assert p[f"{mode}/pool"][1] == 2 * p[f"{mode}/pool"][0]
        assert p[f"{mode}/all_reduces"] > 0
    # Model ranks (0, 1) and (2, 3) hold the data indices' copies: the
    # data-parallel mean leaves them equal bit for bit.
    for a, b in ((0, 2), (1, 3)):
        for k in r[a]:
            np.testing.assert_array_equal(r[a][k], r[b][k], err_msg=k)
    # Replicated leaves (olmo has no norm weights: its norms are
    # non-parametric) are none here; the gathered tree is JAX's.
    got = _gathered(r[:2], mode, "olmo-1b")
    _assert_params(got, want_params, RTOL, 1e-6, mode)


def test_mesh_1x2_qwen3_bf16_matches_jax(runs):
    ref, ranks = runs
    want_losses, want_params = ref[("qwen3-32b", "lazy")]
    r = ranks[2]
    for p in r:
        np.testing.assert_allclose(p["lazy/losses"], want_losses,
                                   rtol=6e-3)
    # The replicated leaves (norm scales, QK-norm) are the same bits on
    # both model ranks: their gradients are all-reduced sums.
    for name in ("layers/attn/q_norm", "layers/attn/k_norm",
                 "layers/attn_norm/scale", "final_norm/scale"):
        np.testing.assert_array_equal(r[0][f"lazy/p/{name}"],
                                      r[1][f"lazy/p/{name}"])
    got = _gathered(r, "lazy", "qwen3-32b")
    # The bf16 products and row-parallel sums round in another order, so
    # each leaf's update (final minus initial) is held against JAX's in
    # norm: within 2^-4 of its size (0.016-0.026 measured on the CPU; a
    # gradient missing its model-group sum is off by order 1).
    g, w, i = _flat(got), _flat(want_params), ref[("qwen3-32b", "init")]
    errs = {n: np.linalg.norm((g[n] - i[n]) - (w[n] - i[n]))
            / np.linalg.norm(w[n] - i[n]) for n in w}
    assert max(errs.values()) <= 2 ** -4, errs
    assert r[0]["cli_losses"].shape == (2,)
    np.testing.assert_array_equal(r[0]["cli_losses"], r[1]["cli_losses"])


# -- refusals under a model axis (one process) --------------------------------


def _fake_mesh(m=2):
    return t_mesh.Mesh((1, m), t_mesh.AXES, 0,
                       LevelGroup(None, tuple(range(m)), 0),
                       LevelGroup(None, (0,), 0))


def _cfg(arch="olmo-1b", opt="momentum_sgd", micro=1, **gf):
    kw = dict(mode="lazy", wire_dtype="float32")
    kw.update(gf)
    return TrainConfig(model=get_smoke(arch)[0],
                       gradientflow=GradientFlowConfig(**kw),
                       optimizer=OptimizerConfig(name=opt), seq_len=S,
                       global_batch=B, microbatches=micro)


# The families train under a model axis; what stays refused for the
# dense family stays refused for each of them.
REFUSED = {
    "moe": _cfg("arctic-480b", guard=GuardConfig()),
    "vlm": _cfg("internvl2-26b", opt="lars"),
    "audio": _cfg("musicgen-large", micro=2),
    "ssm": _cfg("falcon-mamba-7b", overlap="monolithic"),
    "hybrid": _cfg("zamba2-2.7b", wire_format="int8"),
    "monolithic": _cfg(overlap="monolithic"),
    "int8": _cfg(wire_format="int8"), "fp8": _cfg(wire_format="fp8_e4m3"),
    "float16_wire": _cfg(wire_dtype="float16"),
    "guard": _cfg(guard=GuardConfig()), "lars": _cfg(opt="lars"),
    "adamw": _cfg(opt="adamw"), "microbatches": _cfg(micro=2),
    "pallas_ring": _cfg(collective_algo="pallas_ring"),
    "two_level": _cfg(topology=Topology.from_axis_sizes(("node", "gpu"),
                                                        (1, 1))),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_combinations_raise(name):
    with pytest.raises(ValueError, match="ROADMAP.md A.23"):
        Trainer(REFUSED[name], device="cpu", mesh=_fake_mesh())


def test_model_axis_refusals_after_construction():
    trainer = Trainer(_cfg(), device="cpu", mesh=_fake_mesh())
    assert trainer.global_pool == 2 * trainer.pool.size
    assert trainer.num_chunks_global == 2 * trainer.gf.num_chunks
    for call in (lambda: trainer.build_train_window(4),
                 lambda: trainer.build_serve_step(None, mode="decode"),
                 lambda: trainer.replan(mesh=_fake_mesh(4))):
        with pytest.raises(ValueError, match="ROADMAP.md A.23"):
            call()
    trainer.replan(mesh=_fake_mesh(2))  # the same model degree
    # Heads that the rules split but that do not split over the model
    # ranks (olmo-smoke shards 'qkv' and 'kv_heads').
    with pytest.raises(ValueError, match="KV heads"):
        Trainer(_cfg(), device="cpu", mesh=_fake_mesh(3))
    # Checkpoints in a process whose mesh has a model axis.
    from repro_torch.checkpoint.manager import CheckpointManager
    collectives.set_data_group(LevelGroup(None, (0,), 0))
    try:
        with pytest.raises(ValueError, match="ROADMAP.md A.23"):
            CheckpointManager("unused")
    finally:
        collectives.set_data_group(None)


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

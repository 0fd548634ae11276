"""The data reduce's collective algorithms over a pod x data x model mesh,
against the JAX package's Trainer.

* Eight gloo ranks at mesh (2, 2, 2) = ('pod', 'data', 'model') train
  olmo-smoke lazy in f32 compute on an f32 wire, three steps, from the
  port's initial weights (JAX's Trainer starts from them too) cut with
  ``convert.shard_params``, once with each of ``auto``, ``tree``,
  ``two_level`` and ``pallas_ring`` (its plain twin over gloo on the
  CPU). The data topology is the mesh's two
  levels ('pod' over 'data'), laid over each model index's data group:
  - ``auto``'s losses and gathered parameters equal JAX's (2, 2, 2)
    Trainer's within 1e-5 and 2e-5 relative (the row-parallel sums and
    the vocab-parallel log-sum-exp add in another order);
  - ``tree``, ``two_level`` and ``pallas_ring`` equal ``auto``'s (and so
    JAX's) within 2e-5 relative, the f32 sum-order bound of the model-axis
    tests: each algorithm adds the four data ranks' values in its own
    order. They are held to ``auto`` and to JAX's ``auto`` Trainer, not to
    JAX's per-algorithm reduce, three of whose ring tests are red
    (ROADMAP.md C);
  - the topology, θ and each bucket's algorithm equal JAX's for the same
    mesh, and each rank's level groups are the ranks of its data group
    that share its other coordinate.
* In one process: ``--mesh`` parses D, DxM and PxDxM as the JAX CLI does,
  the topology of a ('pod', 'data') mesh's data axes, a checkpoint's
  ``hg`` rows re-split for another data degree at a model degree of 2
  (``checkpoint.reshard.reshard_checkpoint``), and the window's refusal
  on the card naming the model group's gloo sums.

The JAX run is one subprocess on eight placeholder devices, started with
the spawn.
"""
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.parallel import collectives

from repro_torch.models import build_model

from test_torch_model_axis import (B, S, SRC, _flat, _gathered, _spawn,
                                   _specs, _tree, _wait, batches, train_cfg,
                                   train_steps)

MESH = (2, 2, 2)
STEPS = 3
ALGOS = ("auto", "tree", "two_level", "pallas_ring")
RTOL = 2e-5


def _cfg(base, algo):
    return train_cfg(base, "olmo-1b", "lazy", True, collective_algo=algo)


# -- the JAX side --------------------------------------------------------------

_JAX_222 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [{tests!r}, {src!r}]
import numpy as np
from test_torch_model_axis_runtime import jax_222
np.savez({out!r}, **jax_222(dict(np.load({weights!r})), {steps}))
"""


def jax_222(params, steps):
    """JAX's (2, 2, 2) Trainer, ``auto``, from ``params``: losses, final
    parameters, its topology, θ and per-bucket algorithms."""
    import jax
    from repro.configs import base as j_base
    from repro.configs import get_smoke as j_get_smoke
    from repro.data.synthetic import SyntheticLM
    from repro.launch.mesh import make_mesh as j_make_mesh
    from repro.launch.trainer import Trainer as JTrainer
    from repro.parallel.collectives import compat_set_mesh

    from test_torch_model_axis import jax_vma_check_off

    cfg = _cfg(j_base, "auto")
    mesh = j_make_mesh(MESH, ("pod", "data", "model"))
    data = SyntheticLM(cfg.model.vocab_size, seed=0)
    losses = []
    with compat_set_mesh(mesh), jax_vma_check_off():
        tr = JTrainer(cfg, mesh, j_get_smoke("olmo-1b")[1])
        state = tr.init_state(jax.random.PRNGKey(0))
        state = state._replace(params=jax.tree_util.tree_map_with_path(
            lambda path, s: jax.device_put(
                params["/".join(k.key for k in path)], s),
            tr.param_shardings))
        step = tr.build_train_step(tr.gf.stage_for_step(0), donate=False)
        for t in range(steps):
            state, m = step(state, jax.device_put(data.batch(t, B, S)))
            losses.append(float(m["loss"]))
        final = jax.tree_util.tree_map(np.asarray, state.params)
    topo = tr.gf_cfg.topology
    return {"losses": np.asarray(losses),
            "theta": np.asarray(tr.gf.bucket_elems),
            "algos": np.asarray([a.name for a in tr.gf._lazy_algos]),
            "levels": np.asarray([f"{lv.axis}:{lv.size}:{lv.fabric.name}"
                                  for lv in topo.levels]),
            **{f"p/{k}": v for k, v in _flat(final).items()}}


# -- the port's ranks -----------------------------------------------------------

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=world, rank=rank)
    from test_torch_model_axis_runtime import rank_main
    rank_main(rank, world, out)
    dist.destroy_process_group()
""")


def rank_main(rank, world, out):
    """One rank of the (2, 2, 2) mesh: each algorithm's three steps, its
    plan and its level groups, saved to ``out``."""
    mesh = t_mesh.make_mesh(MESH)
    assert mesh.axis_names == t_mesh.POD_AXES and mesh.num_data == 4
    inputs = dict(np.load(os.path.join(os.path.dirname(out),
                                       "inputs.npz")))
    full = _tree(_specs("olmo-1b"), {k[2:]: v for k, v in inputs.items()
                                     if k.startswith("p/")})
    n = mesh.num_data
    rows = slice(mesh.data_index * B // n, (mesh.data_index + 1) * B // n)
    saved = {}
    for algo in ALGOS:
        trainer = Trainer(_cfg(t_base, algo), device="cpu", mesh=mesh)
        local = convert.shard_params(full, trainer.rules, mesh.model_size,
                                     mesh.model_index, specs=trainer.specs)
        state = trainer.init_state(params=convert.params_from_numpy(
            local, "cpu"))
        train_steps(trainer, state, inputs, rows, STEPS, saved, algo)
        topo = trainer.gf_cfg.topology
        saved[f"{algo}/theta"] = np.asarray(trainer.gf.bucket_elems)
        saved[f"{algo}/algos"] = np.asarray(
            [a.name for a in trainer.gf._lazy_algos])
        saved[f"{algo}/levels"] = np.asarray(
            [f"{lv.axis}:{lv.size}:{lv.fabric.name}" for lv in topo.levels])
        groups = collectives.level_groups(topo)
        saved[f"{algo}/groups"] = np.asarray(
            [g.ranks for g in groups.levels])
        saved[f"{algo}/outer"] = np.asarray(groups.outer.ranks)
    np.savez(out, **saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX (2, 2, 2) subprocess and the eight ranks, started together."""
    tmp = tmp_path_factory.mktemp("model_axis_runtime")
    tests = os.path.dirname(os.path.abspath(__file__))
    # The port's draw (no JAX program to compile in this process): both
    # packages start from these weights.
    init = _flat(convert.params_to_numpy(build_model(
        get_smoke("olmo-1b")[0]).init_params(0, "cpu")))
    np.savez(tmp / "weights.npz", **init)
    np.savez(tmp / "inputs.npz",
             **batches(get_smoke("olmo-1b")[0].vocab_size, STEPS),
             **{f"p/{k}": v for k, v in init.items()})
    jax = subprocess.Popen(
        [sys.executable, "-c", _JAX_222.format(
            tests=tests, src=SRC, weights=str(tmp / "weights.npz"),
            out=str(tmp / "jax.npz"), steps=STEPS)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(tests=tests, src=SRC))
    procs = _spawn(script, 8, tmp)
    _wait(procs)
    _wait([jax])
    ranks = [dict(np.load(tmp / f"w8_rank{r}.npz")) for r in range(8)]
    return dict(np.load(tmp / "jax.npz")), ranks


def _rank(p, d, m):
    return (p * 2 + d) * 2 + m


@pytest.mark.parametrize("algo", ALGOS)
def test_pod_data_model_mesh_matches_jax(runs, algo):
    jax, ranks = runs
    want = _tree(_specs("olmo-1b"), {k[2:]: v for k, v in jax.items()
                                     if k.startswith("p/")})
    for r, p in enumerate(ranks):
        got = p[f"{algo}/losses"]
        assert got.shape == (STEPS,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, jax["losses"],
                                   rtol=1e-5 if algo == "auto" else RTOL,
                                   err_msg=f"{algo} rank {r}")
        np.testing.assert_allclose(got, p["auto/losses"], rtol=RTOL)
        # The plan is JAX's for the same mesh: ('pod', 2) over the 56G
        # fabric, ('data', 2) intra-node, θ and each bucket's algorithm.
        np.testing.assert_array_equal(p[f"{algo}/levels"], jax["levels"])
        assert int(p[f"{algo}/theta"]) == int(jax["theta"])
        if algo == "auto":
            np.testing.assert_array_equal(p["auto/algos"], jax["algos"])
        else:
            assert set(p[f"{algo}/algos"]) == {algo}
        # The level groups lie inside the rank's data group: the pod
        # level over p at fixed (d, m), the data level over d at fixed
        # (p, m), the outer group the pod level's.
        pc, dc, mc = r // 4, r // 2 % 2, r % 2
        np.testing.assert_array_equal(
            p[f"{algo}/groups"],
            [[_rank(i, dc, mc) for i in range(2)],
             [_rank(pc, i, mc) for i in range(2)]])
        np.testing.assert_array_equal(p[f"{algo}/outer"],
                                      [_rank(i, dc, mc) for i in range(2)])
    # Each model index's ranks: the gathered tree is JAX's.
    got = _gathered(ranks[:2], f"{algo}/p/", "olmo-1b")
    g, w = _flat(got), _flat(want)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{algo} {name}")
    # The data ranks end with the same parameters, bit for bit.
    for r in range(2, 8):
        for k in ranks[r]:
            if k.startswith(f"{algo}/p/"):
                np.testing.assert_array_equal(ranks[r][k], ranks[r % 2][k],
                                              err_msg=k)


# -- in one process -------------------------------------------------------------


@pytest.mark.parametrize("spec,world,want", [
    ("4", 4, (4, 1)), ("2x2", 4, (2, 2)), ("2x1x2", 4, (2, 1, 2)),
    ("2x2x2", 8, (2, 2, 2)), ("1x2", 2, (1, 2))])
def test_mesh_flag_parses_as_the_jax_cli(monkeypatch, spec, world, want):
    """The JAX CLI's ``--mesh``: one or two sizes are ('data', 'model'),
    three are ('pod', 'data', 'model'); the product must be the world."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)
    shape = train.mesh_shape(spec)
    assert shape == want
    assert t_mesh.axes_for(shape) == (
        ("pod", "data", "model") if spec.count("x") == 2
        else ("data", "model"))
    with pytest.raises(ValueError, match="ranks, the world"):
        train.mesh_shape(f"{world + 1}")
    for bad in ("2x2x2x1", "0x4", "ax2"):
        with pytest.raises(ValueError, match="PxDxM"):
            train.mesh_shape(bad)


def test_pod_data_topology_is_jax_mesh_topology():
    """The trainer's topology for a ('pod', 'data') mesh's data axes is
    the JAX package's ``launch.mesh.mesh_topology``."""
    from repro.launch.mesh import mesh_topology as j_mesh_topology
    from repro_torch.parallel.topology import mesh_topology

    fake = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 devices=np.zeros((2, 4, 2)))
    want = j_mesh_topology(fake, ("pod", "data"))
    got = mesh_topology(8, data_shape=(2, 4))
    assert [(lv.axis, lv.size, lv.fabric.name) for lv in got.levels] == [
        (lv.axis, lv.size, lv.fabric.name) for lv in want.levels]
    assert [lv.axis for lv in mesh_topology(4).levels] == ["data"]
    with pytest.raises(ValueError, match="data axes"):
        mesh_topology(8, data_shape=(2, 2))


def test_reshard_checkpoint_resplits_global_hg_rows(tmp_path):
    """A CSC checkpoint of the global layout at 2 data ranks and a model
    degree of 2 ([2, 2 x pool] hg rows) re-split for one data rank: the
    column totals of ``reshard_hg``, every other leaf's bytes unchanged;
    a live residual refuses."""
    from repro_torch.checkpoint import reshard
    from repro_torch.checkpoint.manager import CheckpointManager

    rng = np.random.default_rng(0)
    hg = rng.standard_normal((2, 16)).astype(np.float32)
    mom = rng.standard_normal(16).astype(np.float32)
    mgr = CheckpointManager(str(tmp_path))
    leaves = [("opt/momentum", mom, "float32", False),
              ("gf/hg", hg, "float32", False),
              ("gf/residual", np.zeros((1, 0), np.float32), "float32",
               False),
              ("staging", np.zeros((0,), np.float32), "float32", True)]
    mgr.write_leaves(4, leaves)
    reshard.reshard_checkpoint(mgr, 4, 1)
    manifest, arrays = mgr._load_verified(4)
    assert [m["name"] for m in manifest["leaves"]] == [n for n, *_ in leaves]
    np.testing.assert_array_equal(arrays[0], mom)
    np.testing.assert_array_equal(arrays[1], reshard.reshard_hg(hg, 1))
    assert arrays[1].shape == (1, 16) and manifest["leaves"][3]["scratch"]
    leaves[2] = ("gf/residual", hg, "float32", False)
    mgr.write_leaves(5, leaves)
    with pytest.raises(ValueError, match="no reshard"):
        reshard.reshard_checkpoint(mgr, 5, 1)


def test_window_on_the_card_names_the_model_groups_gloo_sums(monkeypatch):
    """Under a model axis on one card the model group is gloo: a window
    there refuses when it is built, naming those sums, even when every
    bucket takes the device ring; on the CPU it builds."""
    from repro_torch.launch import window as t_window
    from repro_torch.parallel.collectives import LevelGroup

    mesh = t_mesh.Mesh((1, 2), t_mesh.AXES, 0,
                       LevelGroup(None, (0, 1), 0), LevelGroup(None, (0,), 0))
    cfg = _cfg(t_base, "pallas_ring")
    trainer = Trainer(cfg, device="cpu", mesh=mesh)
    trainer.build_train_window(2)
    plan = trainer.engine.plan_for()
    assert t_window.host_collectives(trainer, plan) == []
    gloo = trainer.model_axis.group = object()
    monkeypatch.setattr(t_window.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(t_window.dist, "get_backend",
                        lambda group=None: "gloo" if group is gloo
                        else "nccl")
    want = ["the model group's gloo sums (the tensor-parallel all-reduces "
            "of the forward and backward)"]
    assert t_window.host_collectives(trainer, plan) == want
    card = types.SimpleNamespace(device=torch.device("cuda"), gf=trainer.gf,
                                 replans=trainer.replans,
                                 model_axis=trainer.model_axis)
    with pytest.raises(ValueError, match="model group's gloo sums"):
        t_window.TrainWindow(card, 2, None, None, plan)

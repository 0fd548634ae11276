"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU.

* Every case of ``tests/test_checkpoint.py`` against the port's manager
  and reshard module: round trip, async save, retention, atomicity, the
  strict shape check, the per-leaf SHA-256, the walk back past a
  truncated checkpoint, bit rot, the reshard plan, the batch split, and
  ``place``.
* The on-disk format is the JAX package's: one converted state (lazy SGD
  on a bf16 wire, CSC, guarded, int8 with its residual) saved by both
  packages gives identical manifests (names, shapes, dtype strings and
  SHA-256 per leaf); a JAX-written checkpoint restored by the port, and
  the reverse, trains on with the other package's losses to rtol 1e-5 on
  an f32 wire (the frameworks' f32 matmuls differ in the last bits, as in
  ``test_torch_trainer.py``).
* ``restore`` writes into ``like``'s tensors (the same ``data_ptr``s); a
  bf16 scratch placeholder round-trips as npz descr '<V2' with
  ``ml_dtypes`` refused; ``reshard_hg`` is JAX's bit for bit and keeps
  the column total.
* The CLI (``--ckpt-dir``) resumed in a new launch gives the
  uninterrupted run's losses bit for bit; two gloo ranks save one
  checkpoint with both ``hg`` rows, and one rank restores it after
  ``reshard_hg`` (the live hg is the re-split row bit for bit), trains
  on, and stays within ``ELASTIC_RTOL`` of the two ranks' losses, a
  bound that a zeroed hg or rank 0's row alone exceeds.
"""
import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import textwrap
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import reshard as j_reshard
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.launch.mesh import make_host_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.parallel.collectives import compat_abstract_mesh, compat_set_mesh
from repro_torch import convert
from repro_torch.checkpoint import reshard
from repro_torch.checkpoint.manager import CheckpointCorrupt, CheckpointManager
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.trainer import Trainer, TrainState

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
B, S = 2, 16

# Losses of one rank after an elastic restore (two ranks' hg re-split to
# one, the same global batch) against the two ranks' own losses: the
# bf16 wire rounds one pool where the ring summed two, and reshard_hg
# keeps the column total, so the re-injected history is the two rows'
# sum where the two ranks' mean took half of it (the JAX package's
# reshard, ROADMAP.md C). Measured here over steps 8-11: 1.15e-3 at
# most; with the restored hg replaced by a control, 2.26e-3 (zeroed) and
# 1.82e-3 (rank 0's row alone). The bound lies between, and the test
# checks that it rejects both controls. (The full-size run on the card
# has its own readings and bound: ``chip_smoke.py`` (x).)
ELASTIC_RTOL = 1.5e-3


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.arange(16.0)},
            "opt": torch.zeros((128,)),
            "step": 7}


def _leaves(tree):
    from repro_torch.checkpoint.manager import flatten
    return [x for _, x in flatten(tree)]


def _equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# -- the cases of tests/test_checkpoint.py ----------------------------------


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = _state()
    mgr.save(7, state, blocking=True)
    step, restored = mgr.restore(_state(seed=1))
    assert step == 7
    _equal(state, restored)


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state(), blocking=False)
    mgr.wait()
    assert mgr.available_steps() == [1]
    assert mgr.writes[0]["step"] == 1 and mgr.writes[0]["bytes"] > 0


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _state(), blocking=True)
    assert mgr.available_steps() == [3, 4]


def test_atomicity_no_partial_checkpoints(tmp_path):
    """A .tmp dir left by a crash must not be listed as restorable."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _state(), blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert mgr.available_steps() == [5]
    assert mgr.latest_step() == 5


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _state(), blocking=True)
    bad = _state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(bad)
    bad = _state()
    bad["opt"] = torch.zeros((128,), dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore(bad)


def test_manifest_records_leaf_checksums(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _state(), blocking=True)
    with open(os.path.join(str(tmp_path), "step_1",
                           "manifest.json")) as f:
        manifest = json.load(f)
    for leaf in manifest["leaves"]:
        assert len(leaf["sha256"]) == 64
    assert [m["name"] for m in manifest["leaves"]] == [
        "opt", "params/b", "params/w", "step"]


def test_restore_falls_back_past_truncated_checkpoint(tmp_path):
    """A truncated arrays.npz must be skipped: restore walks back to the
    newest checkpoint that verifies instead of loading garbage state."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    good = _state(seed=1)
    mgr.save(1, good, blocking=True)
    mgr.save(2, _state(seed=2), blocking=True)
    npz = os.path.join(str(tmp_path), "step_2", "arrays.npz")
    with open(npz, "rb") as f:
        data = f.read()
    with open(npz, "wb") as f:
        f.write(data[: len(data) // 2])
    step, restored = mgr.restore(_state(seed=9))
    assert step == 1
    _equal(good, restored)
    # an explicitly requested corrupt step is strict
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(_state(seed=9), step=2)


def test_restore_detects_bitrot_via_checksum(tmp_path):
    """Flipped payload bytes (length intact) fail the per-leaf SHA-256
    (or the archive CRC); with no intact checkpoint left, restore raises
    CheckpointCorrupt."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _state(), blocking=True)
    npz = os.path.join(str(tmp_path), "step_1", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(_state(seed=9))


@pytest.mark.parametrize("shape,world", [((8, 15), 1), ((8, 15), 3),
                                         ((6, 15), 3), ((1, 0), 3)])
def test_reshard_plan_feasibility(shape, world):
    """The port's only sharded axis is the data degree, on dim 0 of the
    row leaves: as many problems as JAX's plan finds for a
    ``P('data', None)`` leaf on a (data=world, model=1) mesh."""
    got = reshard.plan([("gf/hg", shape), ("params/w", (8, 15))], world)
    want = j_reshard.plan(
        {"w": jax.ShapeDtypeStruct(shape, jnp.float32)},
        {"w": jax.sharding.PartitionSpec(("data", "model"), None)},
        compat_abstract_mesh((world, 1), ("data", "model"))) \
        if shape != (1, 0) else []
    assert len(got) == len(want)


def test_reshard_batch_split():
    assert reshard.reshard_batch_split(256, 16, 8) == (16, 32)
    assert reshard.reshard_batch_split(256, 16, 8) == \
        j_reshard.reshard_batch_split(256, 16, 8)
    with pytest.raises(ValueError):
        reshard.reshard_batch_split(256, 16, 7)


def test_checkpoint_is_mesh_agnostic(tmp_path):
    """Save, restore, then ``place`` on a device: the full logical arrays
    are what an elastic relaunch relies on."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    state = _state()
    mgr.save(3, state, blocking=True)
    _, restored = mgr.restore(_state(seed=9))
    placed = reshard.place(restored, "cpu")
    assert torch.equal(placed["params"]["w"], state["params"]["w"])
    assert placed["step"] == 7


# -- in place, the placeholder, reshard_hg ---------------------------------


def test_restore_keeps_like_data_ptrs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(7, _state(), blocking=True)
    like = _state(seed=5)
    ptrs = [x.data_ptr() for x in _leaves(like) if torch.is_tensor(x)]
    _, restored = mgr.restore(like)
    assert [x.data_ptr() for x in _leaves(restored)
            if torch.is_tensor(x)] == ptrs
    _equal(restored, _state())
    # A snapshot is complete when save returns: a later in-place write to
    # the live tensors does not reach the checkpoint.
    live = _state(seed=3)
    mgr.save(8, live)
    live["params"]["w"].add_(1.0)
    _, got = mgr.restore(_state(seed=9))
    assert torch.equal(got["params"]["w"], _state(seed=3)["params"]["w"])


_PLACEHOLDER = textwrap.dedent("""
    import json, sys, zipfile
    sys.modules["ml_dtypes"] = None  # importing it now raises
    sys.path.insert(0, {src!r})
    import numpy as np, torch
    from repro_torch.checkpoint.manager import CheckpointManager
    d = sys.argv[1]
    state = {{"opt": torch.arange(4.0),
              "staging": torch.zeros(6, dtype=torch.bfloat16)}}
    mgr = CheckpointManager(d)
    mgr.save(3, state, blocking=True)
    head = zipfile.ZipFile(d + "/step_3/arrays.npz").read("leaf_1.npy")
    assert b"'descr': '<V2'" in head, head
    meta = json.load(open(d + "/step_3/manifest.json"))["leaves"][1]
    assert meta["dtype"] == "bfloat16" and meta["scratch"], meta
    like = {{"opt": torch.zeros(4),
             "staging": torch.ones(9, dtype=torch.bfloat16)}}
    step, got = mgr.restore(like)
    assert step == 3 and got["opt"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got["staging"] is like["staging"]
    try:
        mgr.save(4, {{"w": torch.zeros(2, dtype=torch.bfloat16)}})
    except ValueError as e:
        assert "bfloat16" in str(e)
    else:
        raise AssertionError("a bf16 state leaf was saved")
    assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
    print("ok")
""")


def test_bf16_placeholder_roundtrips_without_ml_dtypes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _PLACEHOLDER.format(src=SRC),
         str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-3000:]


@pytest.mark.parametrize("old,new", [(2, 1), (4, 2), (3, 5), (1, 4)])
def test_reshard_hg_matches_jax(old, new):
    hg = np.random.default_rng(old * 10 + new).standard_normal(
        (old, 1000)).astype(np.float32)
    got = reshard.reshard_hg(hg, new)
    want = j_reshard.reshard_hg(hg, new)
    assert got.dtype == want.dtype == np.float32 and got.shape == (new, 1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=0), hg.sum(axis=0), rtol=1e-5)
    if new == 1:  # one row: the column total itself, as numpy sums it
        np.testing.assert_array_equal(got[0], hg.sum(axis=0))


# -- the JAX package's format ------------------------------------------------


def _cfg(base, get_smoke_fn, kind, wire="float32", steps=8):
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    gf = dict(mode="csc" if "csc" in kind else "lazy", bucket_elems=8192,
              chunk_elems=512, sparsity=0.5, warmup_steps=0,
              wire_dtype=wire, use_kernels=True)
    if kind == "guarded":
        gf["guard"] = base.GuardConfig(init_scale=2.0, growth_interval=1000)
    if kind == "int8":
        gf["wire_format"] = "int8"
    return base.TrainConfig(
        model=model, seq_len=S, global_batch=B, attn_chunk=0,
        gradientflow=base.GradientFlowConfig(**gf),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
            weight_decay=1e-4, warmup_steps=2, total_steps=steps,
            schedule="warmup_cosine"))


def _jax_trainer(kind, wire="float32"):
    return JTrainer(_cfg(j_base, j_get_smoke, kind, wire), make_host_mesh(),
                    j_get_smoke("smollm-135m")[1])


def _to_port(trainer, jstate):
    """The port's TrainState holding the JAX state's values (N = 1)."""
    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)
    return TrainState(
        params=convert.params_from_numpy(host(jstate.params), "cpu"),
        opt=convert.opt_state_from_numpy(trainer.opt_name, host(jstate.opt),
                                         "cpu"),
        gf=convert.gf_state_from_numpy(host(jstate.gf), "cpu"),
        step=int(jstate.step),
        guard=convert.scaler_from_numpy(host(jstate.guard), "cpu")
        if jstate.guard else (),
        staging=torch.zeros((trainer.pool.size,),
                            dtype=trainer._pack_dtype))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind,wire", [("lazy", "bfloat16"), ("csc", "float32"),
                                       ("guarded", "float32"),
                                       ("int8", "float32")])
def test_manifests_match_jax(tmp_path, kind, wire):
    """One state (random optimizer and GradientFlow state), converted,
    saved by both packages: the manifests are identical."""
    jt = _jax_trainer(kind, wire)
    rng = np.random.default_rng(0)
    with compat_set_mesh(jt.mesh):
        js = jt.init_state(jax.random.PRNGKey(0))
        rand = lambda a: jnp.asarray(  # noqa: E731
            rng.standard_normal(a.shape).astype(np.float32)) \
            if a.size and a.dtype == jnp.float32 else a
        js = js._replace(opt=jax.tree_util.tree_map(rand, js.opt),
                         gf=jax.tree_util.tree_map(rand, js.gf),
                         step=jnp.asarray(5, jnp.int32))
        JManager(str(tmp_path / "jax")).save(5, js, blocking=True)
    t = Trainer(_cfg(t_base, get_smoke, kind, wire), device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(
        5, _to_port(t, js), blocking=True)
    want = _manifest(str(tmp_path / "jax"), 5)
    got = _manifest(str(tmp_path / "port"), 5)
    assert got == want
    names = [m["name"] for m in got["leaves"]]
    assert names[-1] == "staging" and {"step", "gf/hg"} <= set(names)
    if kind == "guarded":
        assert "guard/scale" in names
    if kind in ("csc", "int8"):
        row = "gf/hg" if kind == "csc" else "gf/residual"
        assert next(m for m in got["leaves"] if m["name"] == row)[
            "shape"] == [1, t.pool.size]


def _batches(n, seed=0, batch=B):
    toks = np.random.default_rng(seed).integers(0, 256, (n, batch, S + 1))
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


@functools.lru_cache(maxsize=None)
def _jax_csc_run():
    """JAX, CSC on an f32 wire: 4 steps, a checkpoint at 2. Returns
    (initial params, losses, the checkpoint's directory)."""
    ckpt_dir = tempfile.mkdtemp(prefix="jax_ckpt_")
    jt = _jax_trainer("csc")
    with compat_set_mesh(jt.mesh):
        state = jt.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        step = jt.build_train_step()
        losses = []
        for i, b in enumerate(_batches(4)):
            if i == 2:
                JManager(ckpt_dir).save(2, state, blocking=True)
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
            losses.append(float(m["loss"]))
    return init, losses, ckpt_dir


def _port_steps(trainer, state, batches):
    step = trainer.build_train_step()
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_restore_trains_on(tmp_path, direction):
    """A checkpoint at step 2 written by one package, restored by the
    other, and trained 2 steps on: the losses are the writer's own
    steps 2-3 to rtol 1e-5 (CSC, f32 wire: hg and the chunk norms
    cross too)."""
    init, j_losses, jdir = _jax_csc_run()
    t = Trainer(_cfg(t_base, get_smoke, "csc"), device="cpu")
    if direction == "jax_to_port":
        state = t.init_state(seed=1)
        step, state = CheckpointManager(jdir).restore(state)
        assert step == 2 and state.step == 2
        assert state.gf.hg.abs().max() > 0
        _, losses = _port_steps(t, state, _batches(4)[2:])
        np.testing.assert_allclose(losses, j_losses[2:], rtol=1e-5)
        return
    pdir = str(tmp_path / "port")
    state = t.init_state(params=convert.params_from_numpy(init, "cpu"))
    state, first = _port_steps(t, state, _batches(4)[:2])
    CheckpointManager(pdir).save(2, state, blocking=True)
    _, rest = _port_steps(t, state, _batches(4)[2:])
    np.testing.assert_allclose(first, j_losses[:2], rtol=1e-5)
    jt = _jax_trainer("csc")
    with compat_set_mesh(jt.mesh):
        step, js = JManager(pdir).restore(jt.init_state(
            jax.random.PRNGKey(1)))
        assert step == 2 and int(js.step) == 2
        jstep = jt.build_train_step()
        losses = []
        for b in _batches(4)[2:]:
            js, m = jstep(js, jax.device_put(
                {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
            losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, rest, rtol=1e-5)


# -- the CLI -----------------------------------------------------------------


def _cli(tmp, record=None, restarts=0):
    from repro_torch.launch import train as train_mod
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq-len", "16", "--gf-mode", "csc",
            "--csc-warmup", "4", "--window-steps", "2", "--use-kernels",
            "--steps", "12", "--ckpt-every", "4", "--ckpt-dir", str(tmp)]
    trainer, losses, _, run = train_mod.train(train_mod.parse_args(argv),
                                              record=record)
    assert run["restarts"] == restarts, run
    return trainer, losses, run


class _SigtermAfter(list):
    """The CLI's window record, sending this process a SIGTERM (a
    scheduler's preemption notice) once the window ending at ``step``
    has run."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step:
            os.kill(os.getpid(), signal.SIGTERM)


def test_cli_resumes_with_the_uninterrupted_bits(tmp_path, capsys):
    """A 12-step CLI run with a checkpoint every 4 is preempted by a
    SIGTERM after step 8: its handler stops the run at that window's
    edge, whose checkpoint the cadence has just saved. A second launch
    with the same flags resumes at 8, and its losses and final state are
    those of one uninterrupted 12-step run, bit for bit. A third launch
    has nothing to do."""
    before = signal.getsignal(signal.SIGTERM)
    _, first, run = _cli(tmp_path / "a", _SigtermAfter(8))
    assert signal.getsignal(signal.SIGTERM) == before
    assert run["preempted"] == 8 and len(first) == 8
    assert "preempted: checkpoint saved at step 8" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "a")).available_steps() == [4, 8]
    _, second, run = _cli(tmp_path / "a")
    assert run["preempted"] is None
    assert "resumed from checkpoint step 8" in capsys.readouterr().out
    _, ref, _ = _cli(tmp_path / "b")
    assert first + second == ref
    a = CheckpointManager(str(tmp_path / "a"))
    b = CheckpointManager(str(tmp_path / "b"))
    assert a.latest_step() == b.latest_step() == 12
    za = zipfile.ZipFile(tmp_path / "a" / "step_12" / "arrays.npz")
    zb = zipfile.ZipFile(tmp_path / "b" / "step_12" / "arrays.npz")
    for name in za.namelist():
        assert za.read(name) == zb.read(name), name
    _, none, _ = _cli(tmp_path / "a")
    assert none == [] and "nothing to do" in capsys.readouterr().out


class _FailOnce(list):
    """The CLI's window record, raising once the window ending at
    ``step`` has run (a host fault inside the window's call)."""

    def __init__(self, step):
        super().__init__()
        self.step, self.fired = step, False

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"host fault after step {self.step}")


def test_cli_restart_is_counted_and_drops_the_failed_pass(tmp_path):
    """A fault in the window 4-5 restarts it from the checkpoint at 4:
    the run stats count the restart and its cause, the record and the
    losses hold each step once, and the losses are the uninterrupted
    run's."""
    record = _FailOnce(6)
    _, got, run = _cli(tmp_path / "a", record, restarts=1)
    assert run["restart_causes"] == ["RuntimeError: host fault after "
                                     "step 6"]
    assert [r["start"] for r in record] == [0, 2, 4, 6, 8, 10]
    _, ref, _ = _cli(tmp_path / "b")
    assert got == ref


# -- two ranks save, one restores --------------------------------------------


_RANK = textwrap.dedent("""
    import sys
    sys.path[:0] = [{tests!r}, {src!r}]
    import numpy as np, torch, torch.distributed as dist
    rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=2, rank=rank)
    from test_torch_checkpoint import elastic_run
    losses, row = elastic_run(d, rank, 2)
    np.savez(d + f"/rank{{rank}}.npz", losses=np.asarray(losses), row=row)
    dist.destroy_process_group()
""")


ELASTIC_ARGV = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                "--gf-mode", "csc", "--csc-warmup", "4", "--chunk-elems",
                "512", "--bucket-elems", "8192", "--batch", "4",
                "--seq-len", "16", "--steps", "12", "--use-kernels"]


def elastic_run(d, rank, world, restore_at=None, hg=None):
    """``chip_smoke.py`` (x) at smoke size: the CLI's CSC config (bf16
    wire, lr 0.2, 4 warm-up steps) over ``pallas_ring`` (its plain twin
    over gloo here), a global batch of 4, 12 steps, a collective
    checkpoint at 8 (``world`` = 2, this rank's half of each batch); or,
    with ``restore_at``, one rank restoring that step in place and
    training on to 12 on the whole batch (``hg``, if given, written over
    the restored hg: the controls). Returns (losses, this rank's hg row
    at step 8, or after the restore)."""
    from repro_torch.launch import train as train_mod

    _, cfg = train_mod.build(train_mod.parse_args(ELASTIC_ARGV))
    t = Trainer(cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, collective_algo="pallas_ring")), device="cpu")
    state = t.init_state(seed=0)
    data = SyntheticLM(cfg.model.vocab_size, seed=0)
    mgr = CheckpointManager(d)
    row = None
    if restore_at is not None:
        step, state = mgr.restore(state, step=restore_at)
        assert step == restore_at
        row = state.gf.hg.numpy().copy()
        if hg is not None:
            state.gf.hg.copy_(torch.from_numpy(hg))
    losses = []
    for s in range(state.step, 12):
        if s == 8 and restore_at is None:
            mgr.save(8, state, blocking=True)
            row = state.gf.hg.numpy().copy()
        stage = t.gf.stage_for_step(s)
        state, m = t.build_train_step(stage)(
            state, data.batch(s, 4 // world, 16, shard=rank))
        losses.append(float(m["loss"]))
    return losses, row


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_save_and_one_rank_elastic_restore(tmp_path):
    """Two gloo ranks save one checkpoint: its hg is [2, pool], each row
    the rank's own. One rank then follows the elastic pattern (restore
    into a host state of the old layout, reshard_hg to one row, save at
    the same step), restores in place and trains steps 8-11 on the whole
    global batch: the column total is kept as numpy sums it, the live hg
    is the re-split row, the parameters and momentum are the
    checkpoint's, and the losses are the two ranks' within ELASTIC_RTOL,
    which the two controls (hg zeroed, rank 0's row alone) exceed."""
    d = str(tmp_path)
    script = tmp_path / "rank.py"
    script.write_text(_RANK.format(
        tests=os.path.dirname(os.path.abspath(__file__)), src=SRC))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, d],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    mgr = CheckpointManager(d)
    meta = {m["name"]: m for m in _manifest(d, 8)["leaves"]}
    from repro_torch.launch import train as train_mod
    t, _ = train_mod.build(train_mod.parse_args(ELASTIC_ARGV))
    assert meta["gf/hg"]["shape"] == [2, t.pool.size]
    assert reshard.plan([(n, m["shape"]) for n, m in meta.items()], 1) == []
    old = reshard.host_like(t.init_state(seed=0), 2)
    step, old = mgr.restore(old, step=8, logical=True)
    for r in range(2):
        np.testing.assert_array_equal(old.gf.hg[r].numpy(), ranks[r]["row"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(t.init_state(seed=0), step=8)  # one rank, two rows
    new = reshard.reshard_state(old, 1)
    np.testing.assert_array_equal(
        new.gf.hg.numpy()[0], old.gf.hg.numpy().sum(axis=0))
    mgr.save(8, new, blocking=True, logical=True)
    _, live = mgr.restore(t.init_state(seed=1), step=8)
    for a, b in zip(t.pool.flat_leaves(live.params) + [live.opt.momentum],
                    t.pool.flat_leaves(old.params) + [old.opt.momentum]):
        assert torch.equal(a, b)
    losses, row = elastic_run(d, 0, 1, restore_at=8)
    np.testing.assert_array_equal(row, new.gf.hg.numpy()[0])
    two = ranks[0]["losses"][8:]
    np.testing.assert_allclose(losses, two, rtol=ELASTIC_RTOL)
    # The controls: the bound sees a hg restored as zeros or as rank 0's
    # row alone.
    for hg in (np.zeros_like(row), ranks[0]["row"]):
        control, _ = elastic_run(d, 0, 1, restore_at=8, hg=hg)
        assert np.max(np.abs(np.asarray(control) / two - 1)) > ELASTIC_RTOL

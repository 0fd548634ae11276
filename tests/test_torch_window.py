"""The port's training window (``Trainer.build_train_window``,
``repro_torch.launch.window``) and the CLI, on the CPU, where the
window's step bodies run eagerly (on a CUDA device they are one CUDA
graph: ``tests/test_torch_cuda.py``).

* Lazy, dense and CSC, unguarded and guarded (a NaN at step 2), K = 4,
  the smoke smollm-135m at sequence 16, batch 2, f32 compute and wire:
  the port's window, without and (dense, lazy) with a deferred tail of 2
  buckets, against the JAX package's ``build_train_window`` from the same
  weights on the same batches: losses to rtol 1e-5, parameters and
  momentum to the trainer tests' rtol 1e-5, atol 1e-6 (the frameworks'
  f32 matmuls differ in the last bits), the stacked ``guard_tripped``
  exactly; the port's pipelined window equal to its unpipelined window
  bit for bit; every returned state flushed.
* A fault scheduled for step 3 trips only step 3 of a K = 6 window.
* Over a gloo group, a window on the card refuses a step with a host
  collective (the flat all-reduce, the CSC and low-bit census sums).
* ``GuardLane(window=4)`` gives the per-step records, and JAX's.
* The CLI: ``--window-steps 4`` gives the losses of ``--window-steps 1``
  (lazy: CSC's snapped stages would change the schedule), and 8 is the
  default.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.launch.mesh import make_host_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.parallel.collectives import compat_set_mesh
from repro.runtime import faults as j_faults
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch.trainer import Trainer, is_flushed
from repro_torch.runtime import faults as t_faults

K, B, S = 4, 2, 16
FAULT = dict(step=2, kind="nan", offset=8, width=4)


def _cfg(base, get_smoke_fn, mode, guarded, tail=0):
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    guard = base.GuardConfig(init_scale=2.0, growth_interval=1000) \
        if guarded else None
    return base.TrainConfig(
        model=model, seq_len=S, global_batch=B, attn_chunk=0,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=4096, chunk_elems=512, sparsity=0.5,
            warmup_steps=0, wire_dtype="float32", guard=guard,
            pipeline_tail_buckets=tail, use_kernels=True),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
            warmup_steps=2, total_steps=16, schedule="constant"))


def _batches(n, seed=0):
    toks = np.random.default_rng(seed).integers(0, 256, (n, B, S + 1))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@functools.lru_cache(maxsize=None)
def _jax_window(mode, guarded):
    """(initial params, losses, tripped, final params, final momentum) of
    JAX's window (dense and lazy with a 2-bucket tail, as the port's
    pipelined twin)."""
    tail = 0 if mode == "csc" else 2
    trainer = JTrainer(_cfg(j_base, j_get_smoke, mode, guarded, tail),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    hook = j_faults.make_hook([j_faults.FaultEvent(**FAULT)]) \
        if guarded else None
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        window = trainer.build_train_window(K, fault_hook=hook)
        state, metrics = window(state, jax.device_put(
            {k: jnp.asarray(v, jnp.int32) for k, v in _batches(K).items()}))
        tripped = np.asarray(metrics["guard_tripped"]) if guarded else None
        return (init, np.asarray(metrics["loss"]), tripped,
                jax.tree_util.tree_map(np.asarray, state.params),
                np.asarray(state.opt.momentum))


def _torch_window(mode, guarded, init, tail):
    trainer = Trainer(_cfg(t_base, get_smoke, mode, guarded, tail),
                      device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    hook = t_faults.make_hook([t_faults.FaultEvent(**FAULT)]) \
        if guarded else None
    window = trainer.build_train_window(K, fault_hook=hook)
    ops.reset_counts()
    state, metrics = window(state, {k: torch.from_numpy(v)
                                    for k, v in _batches(K).items()})
    assert is_flushed(state) and state.step == K
    return trainer, state, metrics, dict(ops.dispatch_counts)


def _flat(trainer, state):
    return [p.numpy() for p in trainer.pool.flat_leaves(state.params)] + [
        state.opt.momentum.numpy()]


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("mode", ["lazy", "dense", "csc"])
def test_window_matches_jax(mode, guarded):
    init, j_loss, j_tripped, j_params, j_mom = _jax_window(mode, guarded)
    tails = (0,) if mode == "csc" else (0, 2)
    runs = {}
    for tail in tails:
        trainer, state, metrics, counts = _torch_window(mode, guarded, init,
                                                        tail)
        assert (trainer._pipeline_plan() is not None) == bool(tail)
        np.testing.assert_allclose(metrics["loss"].numpy(), j_loss,
                                   rtol=1e-5)
        if guarded:
            np.testing.assert_array_equal(metrics["guard_tripped"].numpy(),
                                          j_tripped)
            assert j_tripped.tolist() == [0.0, 0.0, 1.0, 0.0]
            assert int(state.guard.skipped) == 1
        got = _flat(trainer, state)
        want = [p.numpy() for p in trainer.pool.flat_leaves(
            convert.params_from_numpy(j_params, "cpu"))] + [j_mom]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        runs[tail] = (metrics, got, state, counts)
    if len(runs) == 2:
        (m0, p0, s0, c0), (m2, p2, s2, c2) = runs[0], runs[2]
        for k in m0:
            assert torch.equal(m0[k], m2[k]), k
        for a, b in zip(p0, p2):
            np.testing.assert_array_equal(a, b)
        if guarded:
            assert all(torch.equal(a, b) for a, b in zip(s0.guard, s2.guard))
        # The pipelined window moves the tail spans' updates into a lane
        # apply at every step's start and at the flush (one more), each
        # with a master pack of the span.
        assert c2["pool_pack.plain"] == c0["pool_pack.plain"] + 2 * (K + 1)
        assert c2["pool_unpack_update.plain"] == \
            c0["pool_unpack_update.plain"] + 2


@pytest.mark.parametrize("tail", [0, 2])
def test_fault_fires_mid_window(tail):
    """The hook gets the step as a device tensor: scheduled for step 3,
    the fault trips only step 3 of a K = 6 window, and the window's
    state equals the per-step steps' bit for bit."""
    cfg = _cfg(t_base, get_smoke, "lazy", True, tail)
    hook = t_faults.make_hook([t_faults.FaultEvent(step=3, kind="nan",
                                                   offset=0, width=4)])
    batches = {k: torch.from_numpy(v) for k, v in _batches(6).items()}
    trainer = Trainer(cfg, device="cpu")
    state, metrics = trainer.build_train_window(6, fault_hook=hook)(
        trainer.init_state(0), batches)
    assert metrics["guard_tripped"].tolist() == [0, 0, 0, 1, 0, 0]
    assert int(state.guard.skipped) == 1 and state.step == 6
    ref = Trainer(cfg, device="cpu")
    ref_state = ref.init_state(0)
    step = ref.build_train_step(fault_hook=hook)
    losses = []
    for i in range(6):
        ref_state, m = step(ref_state, {k: v[i] for k, v in batches.items()})
        losses.append(m["loss"])
    assert torch.equal(torch.stack(losses), metrics["loss"])
    for a, b in zip(_flat(trainer, state), _flat(ref, ref_state)):
        np.testing.assert_array_equal(a, b)


def test_window_refuses_bad_batches():
    trainer = Trainer(_cfg(t_base, get_smoke, "lazy", False), device="cpu")
    window = trainer.build_train_window(2)
    batches = {k: torch.from_numpy(v) for k, v in _batches(3).items()}
    with pytest.raises(ValueError, match="stacked batch lengths"):
        window(trainer.init_state(0), batches)
    with pytest.raises(ValueError, match="window_steps"):
        trainer.build_train_window(0)


@pytest.mark.parametrize("mode,algo,wire,want", [
    ("lazy", "flat", "native", ["the flat all-reduce of the buckets"]),
    ("lazy", "pallas_ring", "native", []),
    ("csc", "pallas_ring", "native", ["the census sum"]),
    ("lazy", "pallas_ring", "int8", ["the census sum"])])
def test_window_refuses_host_collectives_on_the_card(monkeypatch, mode,
                                                     algo, wire, want):
    """Over a gloo group a step's flat all-reduce and the census sums run
    on the host, which a CUDA graph cannot hold: a window on the card
    refuses such a step when it is built, naming --window-steps 1; over
    NCCL, or without a group, nothing is refused."""
    from repro_torch.launch import window as t_window

    cfg = _cfg(t_base, get_smoke, mode, False)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, collective_algo=algo, wire_format=wire))
    trainer = Trainer(cfg, device="cpu")
    plan = trainer.engine.plan_for()
    assert t_window.host_collectives(trainer, plan) == []
    monkeypatch.setattr(t_window.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(t_window.dist, "get_backend", lambda: "nccl")
    assert t_window.host_collectives(trainer, plan) == []
    monkeypatch.setattr(t_window.dist, "get_backend", lambda: "gloo")
    assert t_window.host_collectives(trainer, plan) == want
    card = types.SimpleNamespace(device=torch.device("cuda"), gf=trainer.gf,
                                 replans=trainer.replans)
    if want:
        with pytest.raises(ValueError, match="--window-steps 1"):
            t_window.TrainWindow(card, K, None, None, plan)
    else:
        t_window.TrainWindow(card, K, None, None, plan)


@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_guard_lane_window_matches_per_step_and_jax(mode):
    kw = [dict(step=2, kind="nan", offset=8, width=4),
          dict(step=5, kind="overflow", offset=40, width=4),
          dict(step=6, kind="bitflip", offset=100, width=6)]
    faults = [t_faults.FaultEvent(**k) for k in kw]
    per_step = t_faults.GuardLane(mode=mode, device="cpu").run(9, faults)
    windowed = t_faults.GuardLane(mode=mode, device="cpu").run(
        9, faults, window=4)
    assert windowed == per_step
    assert [r["tripped"] for r in windowed].count(True) == 3
    want = j_faults.GuardLane(mode=mode).run(
        9, [j_faults.FaultEvent(**k) for k in kw], window=4)
    assert windowed == want


def test_device_step_faults_match_host_step():
    """The where-select and masked-XOR forms write what the host-int
    form writes on the firing step, and nothing on another."""
    rng = np.random.default_rng(0)
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.from_numpy(rng.uniform(0.25, 1.0, 64).astype(
            np.float32)).to(dtype)
        for kind in ("nan", "overflow", "bitflip"):
            ev = [t_faults.FaultEvent(step=1, kind=kind, offset=4, width=8)]
            for step in (0, 1):
                host = t_faults.apply_faults(pool.clone(), step, ev)
                dev = t_faults.apply_faults(pool.clone(),
                                            torch.tensor(step), ev)
                same = host.isnan() == dev.isnan()
                assert bool(same.all())
                assert torch.equal(host[~host.isnan()], dev[~dev.isnan()])
                assert torch.equal(dev, pool) == (step == 0)


def test_cli_window_matches_per_step(capsys):
    from repro_torch.launch import train as train_mod

    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "6", "--batch",
            "2", "--seq-len", "16", "--use-kernels", "--device", "cpu",
            "--gf-mode", "lazy", "--log-every", "1"]
    assert train_mod.parse_args(argv).window_steps == 8
    record = []
    _, windowed, seconds, run = train_mod.train(
        train_mod.parse_args(argv + ["--window-steps", "4"]), record=record)
    _, per_step, _, _ = train_mod.train(
        train_mod.parse_args(argv + ["--window-steps", "1"]))
    assert run["restarts"] == 0
    assert windowed == per_step and len(seconds) == 6
    # A full window of 4, then one of 2 (a second capture on the card).
    assert [(r["start"], r["length"]) for r in record] == [(0, 4), (4, 2)]
    out = capsys.readouterr().out
    assert "step     5 stage 0" in out and "tok/s" in out
    with pytest.raises(ValueError, match="window-steps"):
        train_mod.parse_args(argv + ["--window-steps", "0"])

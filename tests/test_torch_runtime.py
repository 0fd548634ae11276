"""The port's runtime (``repro_torch.runtime``) and elastic replan on the
CPU.

* Every case of ``tests/test_runtime.py``: the straggler detector, the
  elastic controller (with hypothesis, as there), and the supervisor
  (restart, budget, preemption, data skip, the fault before any
  checkpoint, backoff, the walk back past a rotted checkpoint), on the
  port's modules; plus the detector's reports, ``propose`` and
  ``round_checkpoint_every`` equal to the JAX package's.
* The supervisor on a step that updates its state in place (the port's
  Trainer does): a fault before the first checkpoint restarts from the
  start state's values, not from the evolved tensors.
* ``run_windows`` with the data pipeline: a replayed window re-reads its
  batches (``tests/test_loop.py``'s case).
* The replan cases of ``tests/test_soak.py``: the plan cache until a
  replan, the level structure, explicit reduce axes, θ re-tuned, the
  engine's plans through the cache; θ, the per-bucket algorithms and the
  plan keys after a replan equal to JAX's on cluster_v and host_2x4; and
  ``Trainer.replan``: a new key, old steps and windows refused, a new
  step that trains.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GradientFlowConfig as JGFConfig
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.parallel.topology import Topology as JTopology
from repro.runtime import elastic as j_elastic
from repro.runtime import fault_tolerance as j_ft
from repro.runtime import stragglers as j_stragglers
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import GradientFlowConfig
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.parallel.topology import Topology
from repro_torch.runtime import (ElasticController, Preempted,
                                 StragglerDetector, SupervisorConfig,
                                 TrainSupervisor, candidates_for)
from repro_torch.runtime.fault_tolerance import round_checkpoint_every

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")


# -- stragglers ---------------------------------------------------------------

def test_straggler_detector_flags_persistent_slow_host():
    det = StragglerDetector(num_hosts=8, threshold=1.5, patience=3,
                            remesh_after=6)
    base = [1.0] * 8
    for i in range(2):
        rep = det.observe(base)
        assert rep.action == "none"
    slow = list(base)
    slow[3] = 5.0
    actions = []
    for i in range(8):
        rep = det.observe(slow)
        actions.append(rep.action)
    assert "rebatch" in actions          # after `patience` windows
    assert actions[-1] == "remesh"       # after `remesh_after` windows
    assert det.observe(slow).slow_hosts == [3]


def test_straggler_rebatch_lr_rescale():
    det = StragglerDetector(num_hosts=4, patience=1, remesh_after=100)
    rep = det.observe([1.0, 1.0, 1.0, 9.0])
    assert rep.action == "rebatch"
    assert rep.lr_rescale == pytest.approx(0.75)


def test_straggler_recovery_resets_flags():
    det = StragglerDetector(num_hosts=4, patience=2, alpha=1.0)
    det.observe([1, 1, 1, 5])
    rep = det.observe([1, 1, 1, 1])
    assert rep.action == "none"
    assert det.flags[3] == 0


def test_straggler_reset_shrinks_host_count():
    det = StragglerDetector(num_hosts=4, patience=1, alpha=1.0)
    det.observe([1.0, 1.0, 1.0, 9.0])
    assert det.flags[3] == 1
    det.reset(num_hosts=3)
    assert det.num_hosts == 3
    assert det.ewma == [None] * 3 and det.flags == [0] * 3
    rep = det.observe([1.0, 1.0, 1.0])
    assert rep.action == "none"
    assert det.ewma == [1.0, 1.0, 1.0]


def test_straggler_reset_grows_host_count():
    det = StragglerDetector(num_hosts=2, patience=1)
    det.observe([1.0, 1.0])
    det.reset(num_hosts=5)
    rep = det.observe([1.0] * 5)
    assert rep.action == "none" and det.num_hosts == 5


def test_straggler_reset_clears_stale_flags_same_count():
    det = StragglerDetector(num_hosts=4, patience=2, alpha=1.0)
    det.observe([1.0, 1.0, 1.0, 9.0])
    det.reset()
    assert det.num_hosts == 4
    rep = det.observe([1.0, 1.0, 1.0, 9.0])
    assert rep.action == "none"
    assert det.flags[3] == 1


def test_straggler_reset_rejects_empty():
    det = StragglerDetector(num_hosts=4)
    with pytest.raises(AssertionError):
        det.reset(num_hosts=0)


@hypothesis.given(
    times=st.lists(st.lists(st.floats(0.1, 10.0), min_size=5, max_size=5),
                   min_size=1, max_size=30),
    patience=st.integers(1, 4), remesh_after=st.integers(1, 8))
@hypothesis.settings(max_examples=40, deadline=None)
def test_straggler_reports_match_jax(times, patience, remesh_after):
    ours = StragglerDetector(5, patience=patience, remesh_after=remesh_after)
    ref = j_stragglers.StragglerDetector(5, patience=patience,
                                         remesh_after=remesh_after)
    for t in times:
        a, b = ours.observe(t), ref.observe(t)
        assert (a.slow_hosts, a.action, a.lr_rescale) == \
            (b.slow_hosts, b.action, b.lr_rescale)


# -- elastic ------------------------------------------------------------------

def test_elastic_candidates():
    c = candidates_for(256, model_parallel=16)
    assert c.shape == (16, 16)
    c = candidates_for(512, model_parallel=16, pods=2)
    assert c.shape == (2, 16, 16)
    assert candidates_for(250, model_parallel=16) is None


def test_elastic_controller_respects_batch():
    ctl = ElasticController(model_parallel=16, global_batch=256)
    c = ctl.propose(healthy_devices=256)
    assert c.shape == (16, 16)
    c = ctl.propose(healthy_devices=240)
    assert c is not None
    assert 256 % (c.num_devices // 16) == 0


def test_elastic_propose_rounds_down_ragged_counts():
    ctl = ElasticController(model_parallel=16, global_batch=240)
    c = ctl.propose(healthy_devices=250)
    assert c is not None and c.num_devices == 240
    assert candidates_for(250, model_parallel=16) is None


def _viable_data_totals(healthy, mp, pods, gb):
    unit = mp * pods
    return [d for d in range(1, healthy // unit + 1) if gb % (d * pods) == 0]


@hypothesis.given(
    healthy=st.integers(min_value=0, max_value=2048),
    mp=st.integers(min_value=1, max_value=64),
    pods=st.integers(min_value=1, max_value=4),
    gb=st.integers(min_value=1, max_value=65536))
@hypothesis.settings(max_examples=60, deadline=None)
def test_elastic_propose_matches_oracle_and_jax(healthy, mp, pods, gb):
    """propose returns the LARGEST viable mesh (TP degree kept, global
    batch divided, device count fits), None exactly when the oracle finds
    no viable data degree, and the JAX package's proposal."""
    cand = ElasticController(model_parallel=mp, global_batch=gb) \
        .propose(healthy, pods=pods)
    ref = j_elastic.ElasticController(model_parallel=mp, global_batch=gb) \
        .propose(healthy, pods=pods)
    assert (cand is None) == (ref is None)
    if cand is not None:
        assert (cand.shape, cand.axis_names) == (ref.shape, ref.axis_names)
    viable = _viable_data_totals(healthy, mp, pods, gb)
    if not viable:
        assert cand is None
    else:
        assert cand.num_devices == max(viable) * mp * pods
        assert cand.num_devices <= healthy
        assert cand.shape[-1] == mp
        assert gb % (cand.num_devices // mp) == 0


@hypothesis.given(
    healthy=st.integers(min_value=0, max_value=1024),
    delta=st.integers(min_value=0, max_value=512),
    mp=st.integers(min_value=1, max_value=32),
    gb=st.sampled_from([1, 96, 256, 3 * 5 * 7, 16128, 65536]))
@hypothesis.settings(max_examples=60, deadline=None)
def test_elastic_propose_monotone_in_healthy(healthy, delta, mp, gb):
    ctl = ElasticController(model_parallel=mp, global_batch=gb)
    lo, hi = ctl.propose(healthy), ctl.propose(healthy + delta)
    lo_n = 0 if lo is None else lo.num_devices
    hi_n = 0 if hi is None else hi.num_devices
    assert hi_n >= lo_n


@pytest.mark.parametrize("window", [1, 2, 3, 4, 8, 50, 64])
def test_round_checkpoint_every_matches_jax(window):
    for every in (1, 3, 7, 8, 12, 48, 50, 51, 100):
        assert round_checkpoint_every(every, window) == \
            j_ft.round_checkpoint_every(every, window)


# -- supervisor ---------------------------------------------------------------

def _mini_state():
    return {"x": torch.zeros((4,)), "step_val": 0}


def _next(state, step):
    return {"x": state["x"] + 1.0, "step_val": step + 1}


def _count_step(calls):
    def step_fn(step, state):
        calls["n"] += 1
        return _next(state, step)
    return step_fn


def test_supervisor_restart_from_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=5,
                                                 max_restarts=2))
    calls = {"n": 0}
    faulted = {"done": False}

    def fault(step):
        if step == 7 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("injected node failure")

    final = sup.run(_mini_state(), 0, 12, _count_step(calls),
                    fault_injector=fault)
    assert float(final["x"][0]) == 12.0
    assert sup.restarts == 1
    assert calls["n"] == 12 + (7 - 5)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                                 max_restarts=2))

    def step_fn(step, state):
        raise RuntimeError("always failing")

    with pytest.raises(RuntimeError):
        sup.run(_mini_state(), 0, 5, step_fn)
    assert sup.restarts == 3


def test_supervisor_preemption_checkpoints(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100))

    def step_fn(step, state):
        if step == 3:
            sup.request_preemption()
        return _next(state, step)

    with pytest.raises(Preempted):
        sup.run(_mini_state(), 0, 10, step_fn)
    assert ckpt.latest_step() == 4


def test_supervisor_on_restore_skips_data(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=2,
                                                 max_restarts=1))
    restored_steps = []
    faulted = {"done": False}

    def fault(step):
        if step == 5 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("boom")

    sup.run(_mini_state(), 0, 8, _count_step({"n": 0}),
            on_restore=restored_steps.append, fault_injector=fault)
    assert restored_steps == [4]


def test_supervisor_fault_on_step_zero_before_any_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                                 max_restarts=2))
    calls = {"n": 0}
    faulted = {"done": False}
    restored = []

    def fault(step):
        if step == 0 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("dead on arrival")

    final = sup.run(_mini_state(), 0, 6, _count_step(calls),
                    on_restore=restored.append, fault_injector=fault)
    assert sup.restarts == 1
    assert restored == [0]
    assert calls["n"] == 6
    assert float(final["x"][0]) == 6.0


def test_supervisor_no_checkpoint_restart_does_not_replay_on_evolved_state(
        tmp_path):
    """Fault after some steps but before the first checkpoint: restart
    must rewind to the initial state, not replay on the evolved one."""
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                                 max_restarts=2))
    calls = {"n": 0}
    faulted = {"done": False}

    def fault(step):
        if step == 3 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("pre-checkpoint failure")

    final = sup.run(_mini_state(), 0, 6, _count_step(calls),
                    fault_injector=fault)
    assert calls["n"] == 6 + 3
    assert float(final["x"][0]) == 6.0
    assert final["step_val"] == 6


@pytest.mark.parametrize("windows", [False, True])
def test_supervisor_start_state_survives_in_place_steps(tmp_path, windows):
    """The port's Trainer updates its tensors in place, so the state the
    run started with IS the evolved one: a fault before the first
    checkpoint must restore the start state's values into the live
    tensors (the same tensors, so a captured window stays valid)."""
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                                 max_restarts=2))
    state = {"x": torch.zeros((4,)), "step_val": 0}
    ptr = state["x"].data_ptr()
    seen = []
    faulted = {"done": False}

    def fault(step):
        if step == 3 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("pre-checkpoint failure")

    def step_fn(step, st):
        seen.append((step, float(st["x"][0])))
        st["x"].add_(1.0)       # in place, as the Trainer's step
        st["step_val"] = step + 1
        return st

    if windows:
        final = sup.run_windows(
            state, 0, 6, lambda s, n, st: [step_fn(s + i, st)
                                           for i in range(n)][-1], 1,
            fault_injector=fault)
    else:
        final = sup.run(state, 0, 6, step_fn, fault_injector=fault)
    assert float(final["x"][0]) == 6.0       # NOT 9.0
    assert final["step_val"] == 6
    assert final["x"].data_ptr() == ptr
    assert seen[3] == (0, 0.0)               # the replay starts from 0


def test_supervisor_budget_exhausted_with_save_in_flight(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=5,
                                                 max_restarts=2))
    restored = []

    def fault(step):
        if step == 6:
            raise RuntimeError("node keeps dying")

    with pytest.raises(RuntimeError, match="node keeps dying"):
        sup.run(_mini_state(), 0, 10, _count_step({"n": 0}),
                on_restore=restored.append, fault_injector=fault)
    assert sup.restarts == 3
    assert restored == [5, 5]
    assert ckpt.latest_step() == 5
    step, state = ckpt.restore(_mini_state())
    assert step == 5 and float(state["x"][0]) == 5.0


def test_supervisor_preemption_during_final_step(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100))

    def step_fn(step, state):
        if step == 9:
            sup.request_preemption()
        return _next(state, step)

    final = sup.run(_mini_state(), 0, 10, step_fn)
    assert float(final["x"][0]) == 10.0
    assert ckpt.latest_step() == 10
    with pytest.raises(Preempted):
        sup.run(final, 10, 20, step_fn)
    sup.clear_preemption()
    final = sup.run(final, 10, 20, step_fn)
    assert final["step_val"] == 20


def test_supervisor_backoff_and_restart_causes(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sleeps = []
    sup = TrainSupervisor(
        ckpt,
        SupervisorConfig(checkpoint_every=100, max_restarts=3,
                         backoff_base_s=1.0, backoff_factor=2.0,
                         backoff_max_s=3.0, backoff_jitter=0.0, seed=0),
        sleep_fn=sleeps.append)
    fails = {"n": 0}

    def fault(step):
        if step == 2 and fails["n"] < 3:
            fails["n"] += 1
            raise RuntimeError(f"boom {fails['n']}")

    final = sup.run(_mini_state(), 0, 5, _count_step({"n": 0}),
                    fault_injector=fault)
    assert float(final["x"][0]) == 5.0
    assert sleeps == [1.0, 2.0, 3.0]
    stats = sup.run_stats()
    assert stats["restarts"] == 3
    assert stats["restart_causes"] == [
        "RuntimeError: boom 1", "RuntimeError: boom 2",
        "RuntimeError: boom 3"]
    assert stats["backoffs_s"] == sleeps


def _delays(tmp_path, mod, manager, seed, tag):
    ckpt = manager(str(tmp_path) + f"/{tag}", keep=3)
    sleeps = []
    sup = mod.TrainSupervisor(
        ckpt,
        mod.SupervisorConfig(checkpoint_every=100, max_restarts=3,
                             backoff_base_s=1.0, backoff_factor=1.0,
                             backoff_max_s=10.0, backoff_jitter=0.5,
                             seed=seed),
        sleep_fn=sleeps.append)
    fails = {"n": 0}

    def fault(step):
        if step == 0 and fails["n"] < 3:
            fails["n"] += 1
            raise RuntimeError("boom")

    state = {"x": jnp.zeros((4,))} if mod is j_ft else _mini_state()
    sup.run(state, 0, 2, lambda s, st: st, fault_injector=fault)
    return sleeps


def test_supervisor_backoff_jitter_is_seeded(tmp_path):
    """Deterministic for a seed, bounded by +/- jitter, and the JAX
    package's delays."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    import repro_torch.runtime.fault_tolerance as t_ft

    a = _delays(tmp_path, t_ft, CheckpointManager, 0, "a")
    b = _delays(tmp_path, t_ft, CheckpointManager, 0, "b")
    assert a == b and len(a) == 3
    assert all(0.5 <= d <= 1.5 for d in a)
    assert a == _delays(tmp_path, j_ft, JManager, 0, "j")


def test_supervisor_backoff_disabled_by_default(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    called = []
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                                 max_restarts=1),
                          sleep_fn=called.append)
    faulted = {"done": False}

    def fault(step):
        if step == 1 and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("boom")

    sup.run(_mini_state(), 0, 3, _count_step({"n": 0}),
            fault_injector=fault)
    assert called == []
    assert sup.run_stats()["backoffs_s"] == [0.0]


def test_supervisor_restores_from_older_checkpoint_when_newest_rots(
        tmp_path):
    import os

    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=2,
                                                 max_restarts=1))
    faulted = {"done": False}
    restored = []

    def fault(step):
        if step == 5 and not faulted["done"]:
            faulted["done"] = True
            ckpt.wait()
            npz = os.path.join(str(tmp_path), "step_4", "arrays.npz")
            with open(npz, "r+b") as f:
                f.truncate(os.path.getsize(npz) // 2)
            raise RuntimeError("node died, checkpoint rotted")

    final = sup.run(_mini_state(), 0, 8, _count_step({"n": 0}),
                    on_restore=restored.append, fault_injector=fault)
    assert restored == [2]
    assert float(final["x"][0]) == 8.0


def test_run_windows_replays_the_same_batches(tmp_path):
    """A window that dies after consuming its batches is replayed from
    the checkpoint with exactly those batches (``next_at`` by step)."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticLM

    pipe = DataPipeline(SyntheticLM(64, seed=0), 2, 8)
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=2,
                                                 max_restarts=1))
    got = {}
    faulted = {"done": False}

    def window_fn(step, length, state):
        for i in range(length):
            b = pipe.next_at(step + i)
            got.setdefault(step + i, []).append(b["tokens"].clone())
        if step <= 3 < step + length and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("node failure mid-window")
        return {"x": state["x"] + length, "step_val": step + length}

    pipe.start(0)
    final = sup.run_windows(_mini_state(), 0, 8, window_fn, 2,
                            on_restore=pipe.skip_to)
    pipe.stop()
    assert any(len(bs) > 1 for bs in got.values())
    for bs in got.values():
        for b in bs[1:]:
            assert torch.equal(b, bs[0])
    assert final["step_val"] == 8 and ckpt.available_steps() == [4, 6, 8]


# -- replan (tests/test_soak.py) ----------------------------------------------


def _gf(topo, num_data):
    pool = GradientPool({"a": (3000,), "b": (500,), "c": (80,)})
    cfg = GradientFlowConfig(mode="lazy", wire_dtype="float16",
                             warmup_steps=0, bucket_elems=1024,
                             auto_bucket=True, topology=topo,
                             reduce_axes=topo.axes,
                             collective_algo="auto", overlap="staged")
    return GradientFlow(cfg, pool, num_data_shards=num_data)


def _jgf(topo, num_data):
    pool = JPool({"a": jnp.zeros((3000,)), "b": jnp.zeros((500,)),
                  "c": jnp.zeros((80,))})
    cfg = JGFConfig(mode="lazy", wire_dtype="float16", warmup_steps=0,
                    bucket_elems=1024, auto_bucket=True, topology=topo,
                    reduce_axes=topo.axes, collective_algo="auto",
                    overlap="staged")
    return JGradientFlow(cfg, pool, num_data_shards=num_data)


def test_plan_is_cached_until_replan():
    gf = _gf(Topology.cluster_v(nodes=8, gpus_per_node=4), 32)
    p1 = gf.plan()
    assert gf.plan() is p1
    assert p1.plan_key == gf.plan_cache_key()
    p1.validate()
    gf.replan(Topology.cluster_v(nodes=4, gpus_per_node=4),
              num_data_shards=16)
    p2 = gf.plan()
    assert p2 is not p1
    assert p2.plan_key != p1.plan_key
    assert p2.plan_key == gf.plan_cache_key()
    assert p2.num_data_shards == 16
    p2.validate()


def test_replan_changes_level_structure():
    gf = _gf(Topology.cluster_v(nodes=8, gpus_per_node=4), 32)
    gf.replan(Topology.from_axis_sizes(("data",), (30,)),
              num_data_shards=30)
    plan = gf.plan()
    plan.validate()
    assert gf.cfg.reduce_axes == ("data",)
    assert len(gf.cfg.topology.levels) == 1
    assert {t.algo.name for t in plan.tasks} == {"flat"}


def test_replan_keeps_explicit_reduce_axes():
    gf = _gf(Topology.cluster_v(nodes=8, gpus_per_node=4), 32)
    gf.replan(Topology.from_axis_sizes(("node", "gpu"), (4, 4)),
              num_data_shards=16, reduce_axes=("pod", "data"))
    assert gf.cfg.reduce_axes == ("pod", "data")


def test_replan_retunes_theta():
    gf = _gf(Topology.cluster_v(nodes=64, gpus_per_node=8), 512)
    gf.replan(Topology.from_axis_sizes(("data",), (2,)), num_data_shards=2)
    plan = gf.plan()
    plan.validate()
    assert plan.tasks[-1].end == gf.pool.size


def test_engine_plan_for_routes_through_cache():
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.engine import OverlapEngine

    gf = _gf(Topology.cluster_v(nodes=8, gpus_per_node=4), 32)
    eng = OverlapEngine(gf, "momentum_sgd",
                        OptimizerConfig(name="momentum_sgd"))
    p1 = eng.plan_for()
    assert p1 is gf.plan()
    eng.replan(Topology.cluster_v(nodes=4, gpus_per_node=4),
               num_data_shards=16)
    p2 = eng.plan_for()
    assert p2.plan_key != p1.plan_key
    assert p2.num_data_shards == 16


_TOPOS = {
    "cluster_v": (lambda m, n, g: m.Topology.cluster_v(nodes=n,
                                                       gpus_per_node=g),
                  [(8, 4), (4, 4), (64, 8), (1, 2)]),
    "host_2x4": (lambda m, p, d: m.Topology.host_mesh(("pod", "data"),
                                                      (p, d)),
                 [(2, 4), (1, 4), (2, 2), (4, 8)]),
}


@pytest.mark.parametrize("name", sorted(_TOPOS))
def test_replan_matches_jax(name):
    """After each replan in a sequence of topologies: θ, the per-bucket
    algorithms and bounds, and the plan key equal to JAX's."""
    import repro.parallel.topology as j_topo_mod
    import repro_torch.parallel.topology as t_topo_mod

    make, shapes = _TOPOS[name]
    first = shapes[0]
    ours = _gf(make(t_topo_mod, *first), first[0] * first[1])
    ref = _jgf(make(j_topo_mod, *first), first[0] * first[1])
    for shape in shapes[1:] + [first]:
        n = shape[0] * shape[1]
        ours.replan(make(t_topo_mod, *shape), num_data_shards=n)
        ref.replan(make(j_topo_mod, *shape), num_data_shards=n)
        a, b = ours.plan(), ref.plan()
        assert ours.bucket_elems == ref.bucket_elems, shape
        assert a.plan_key == b.plan_key, shape
        assert [(t.start, t.end, t.algo.name) for t in a.tasks] == \
            [(t.start, t.end, t.algo.name) for t in b.tasks], shape


def _trainer_cfg():
    import dataclasses
    from repro_torch.configs import base, get_smoke

    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model, seq_len=16, global_batch=2, attn_chunk=0,
        gradientflow=base.GradientFlowConfig(
            mode="lazy", bucket_elems=4096, wire_dtype="float32",
            warmup_steps=0, use_kernels=True),
        optimizer=base.OptimizerConfig(name="momentum_sgd",
                                       learning_rate=0.1, momentum=0.9,
                                       total_steps=4))


def test_trainer_replan_recompiles_step_plan():
    """Trainer.replan on one rank to a two-level topology: a new plan
    key, the topology's axes as reduce axes; the step and the window
    built before refuse to run (they hold the old plan); a new step
    trains on."""
    from repro_torch.launch.trainer import Trainer

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 2, 17)))
    batch = {"tokens": toks[0, :, :-1], "labels": toks[0, :, 1:]}
    trainer = Trainer(_trainer_cfg(), device="cpu")
    key_before = trainer.gf.plan_cache_key()
    state = trainer.init_state(seed=0)
    step = trainer.build_train_step()
    window = trainer.build_train_window(2)
    state, m1 = step(state, batch)
    trainer.replan(topology=Topology.host_mesh(("pod", "data"), (1, 1)))
    assert trainer.gf.plan_cache_key() != key_before
    plan = trainer.engine.plan_for()
    plan.validate()
    assert plan.plan_key == trainer.gf.plan_cache_key()
    assert trainer.gf.cfg.reduce_axes == ("pod", "data")
    assert trainer.gf_cfg is trainer.gf.cfg and trainer.num_data == 1
    with pytest.raises(ValueError, match="replan"):
        step(state, batch)
    with pytest.raises(ValueError, match="replan"):
        window(state, {k: v[None] for k, v in batch.items()})
    state, m2 = trainer.build_train_step()(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    with pytest.raises(ValueError, match="ranks"):
        trainer.replan(topology=Topology.flat("data", 4))

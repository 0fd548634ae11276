"""The port's elastic soak (``runtime.soak``) against the JAX package's:
for the same config and schedule the trace must be the JAX trace, key for
key (the events, the plan keys' repr, the wire bytes, the predicted step
times rounded to 9 places, ``final`` and the guard lane's records), and
``render_trace`` and ``dryrun --soak`` must print the same text.

Cases: the short schedule of ``tests/test_soak.py`` with a 6-step guard
lane (the port's lane on the CPU), the default 300-step schedule without
the lane, the no-viable-mesh abort, and a preemption that lands on a step
the checkpoint cadence just saved (the port writes that step once, the
JAX supervisor twice; the trace is the same).
"""
import dataclasses

import pytest

from repro.runtime import soak as j_soak
from repro_torch.runtime import soak as t_soak


def _events(mod, events):
    return tuple(mod.SoakEvent(**dataclasses.asdict(e)) for e in events)


SHORT = dict(num_steps=120, checkpoint_every=10, max_restarts=3)
SHORT_SCHEDULE = (
    t_soak.SoakEvent(step=15, kind="fail", host=7),
    t_soak.SoakEvent(step=30, kind="straggler", host=12, factor=4.0),
    t_soak.SoakEvent(step=70, kind="preempt", host=3),
    t_soak.SoakEvent(step=95, kind="fail", host=1),
)
ABORT = dict(num_hosts=2, gpus_per_node=4, model_parallel=2, global_batch=8,
             num_steps=40, checkpoint_every=5, guard_steps=0)
ABORT_SCHEDULE = (t_soak.SoakEvent(step=5, kind="preempt", host=0),
                  t_soak.SoakEvent(step=15, kind="preempt", host=1))
# The flag set at step 19 raises at the top of step 20, which the
# cadence (every 10) has just saved.
ON_SAVE = dict(num_steps=60, checkpoint_every=10, guard_steps=0)
ON_SAVE_SCHEDULE = (t_soak.SoakEvent(step=19, kind="preempt", host=3),)

CASES = {
    "short_guarded": (dict(SHORT, guard_steps=6), SHORT_SCHEDULE),
    "default": (dict(guard_steps=0), None),
    "abort": (ABORT, ABORT_SCHEDULE),
    "preempt_on_saved_step": (ON_SAVE, ON_SAVE_SCHEDULE),
}


def _run(name, tmp_path):
    fields, schedule = CASES[name]
    j_h = j_soak.SoakHarness(
        j_soak.SoakConfig(**fields), str(tmp_path / "j"),
        schedule=None if schedule is None else _events(j_soak, schedule))
    t_h = t_soak.SoakHarness(t_soak.SoakConfig(**fields),
                             str(tmp_path / "t"), schedule=schedule,
                             device="cpu")
    return j_h, j_h.run(), t_h, t_h.run()


@pytest.mark.parametrize("name", sorted(CASES))
def test_soak_trace_equals_jax(name, tmp_path):
    _, want, t_h, got = _run(name, tmp_path)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert t_soak.render_trace(got) == j_soak.render_trace(want)
    if name == "abort":
        assert "no viable mesh" in got["final"]["aborted"]
    if name == "short_guarded":
        assert got["guard"]["lazy"]["truth_table"]["false_trips"] == 0
    if name == "preempt_on_saved_step":
        # The cadence's save and the re-split state's save: the port's
        # supervisor does not write step 20 a second time.
        assert [w["step"] for w in t_h.ckpt.writes].count(20) == 2
        assert got["events"][0]["kind"] == "preemption"
        assert got["events"][0]["step"] == 20


def test_soak_defaults_are_jax():
    assert dataclasses.asdict(t_soak.SoakConfig()) == \
        dataclasses.asdict(j_soak.SoakConfig())
    cfg = t_soak.SoakConfig()
    assert [dataclasses.asdict(e) for e in t_soak.default_schedule(cfg)] == \
        [dataclasses.asdict(e) for e in j_soak.default_schedule(
            j_soak.SoakConfig())]
    assert [dataclasses.asdict(e) for e in t_soak.default_numeric_faults(24)
            ] == [dataclasses.asdict(e)
                  for e in j_soak.default_numeric_faults(24)]


"""The numeric guard rail of the port (``repro_torch.core.guard``,
``optim.scaler``, ``runtime.faults``) against the JAX package's, on the
CPU.

* The scaler's transitions over a seeded 64-step verdict sequence that
  reaches both clamps, exactly.
* ``overflow_limit``, ``per_chunk_limit``, ``health_word`` and
  ``flags_from_census`` on inputs holding NaN, ±Inf, 2^120 and zeros.
* ``_corrupt`` / ``apply_faults`` on bf16 and f32 pools: the bit flip and
  the overflow bit for bit, NaN by class (the frameworks write different
  NaN words).
* ``GuardLane`` records equal to JAX's, field for field, lazy and CSC.
* The Trainer with a fault hook (a NaN at step 1, an overflow at step 2)
  against JAX's Trainer, lazy monolithic and CSC staged: losses to
  rtol 1e-5, the scale and skip trajectories equal.

Inputs come from seeds with numpy and go to both packages; the port runs
its kernels' plain versions (CPU tensors), JAX runs as tests/test_guard.py
runs it (one data device).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.core import guard as j_guard
from repro.launch.mesh import make_host_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.optim import scaler as j_scaler
from repro.parallel.collectives import compat_set_mesh
from repro.runtime import faults as j_faults
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.core import guard as t_guard
from repro_torch.launch.trainer import Trainer
from repro_torch.optim import scaler as t_scaler
from repro_torch.runtime import faults as t_faults

# -- the scaler ---------------------------------------------------------------


def test_scaler_update_matches_jax():
    """64 transitions: four trips from 4.0 (clamped at min_scale 1.0),
    twelve clean steps (grows every 3 steps, clamped at max_scale 16.0),
    then a seeded mix; every field equal at every step, dtypes too."""
    kw = dict(init_scale=4.0, growth_interval=3, growth_factor=2.0,
              backoff_factor=0.5, min_scale=1.0, max_scale=16.0)
    jcfg, tcfg = j_base.GuardConfig(**kw), t_base.GuardConfig(**kw)
    rng = np.random.default_rng(0)
    oks = [False] * 4 + [True] * 12 + list(rng.random(48) < 0.7)
    js, ts = j_scaler.init(jcfg), t_scaler.init(tcfg, "cpu")
    assert ts.scale.dtype == torch.float32
    assert ts.growth_count.dtype == ts.skipped.dtype == torch.int32
    scales = []
    for ok in oks:
        js = j_scaler.update(js, jnp.asarray(ok), jcfg)
        ts = t_scaler.update(ts, torch.tensor(ok), tcfg)
        for name, a, b in zip(js._fields, js, ts):
            assert b.dim() == 0 and np.asarray(a) == b.numpy(), (name, ok)
        scales.append(float(ts.scale))
    assert min(scales) == 1.0 and max(scales) == 16.0
    assert int(ts.skipped) == sum(not ok for ok in oks)
    back = convert.scaler_from_numpy(js, "cpu")
    for a, b in zip(back, ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(convert.scaler_to_numpy(ts), js):
        assert a.dtype == np.asarray(b).dtype and a == np.asarray(b)


# -- the flags ----------------------------------------------------------------


@pytest.mark.parametrize("wire", ["bfloat16", "float32", "float16"])
def test_overflow_limit_matches_jax(wire):
    kw = dict(overflow_fraction=1.0 / 512.0)
    got = t_guard.overflow_limit(t_base.GuardConfig(**kw), wire)
    assert got == j_guard.overflow_limit(j_base.GuardConfig(**kw), wire)
    assert got == t_guard.overflow_limit(t_base.GuardConfig(**kw),
                                         getattr(torch, wire))
    assert (got == float("inf")) == (wire == "float16")


SPECIAL = np.array([np.nan, np.inf, -np.inf, 2.0 ** 120, 0.0],
                   dtype=np.float32)


def _segments():
    """Segments of a seeded normal with one special value each, a clean
    one and an all-zero one."""
    rng = np.random.default_rng(1)
    segs = [rng.standard_normal(37).astype(np.float32)]
    for v in SPECIAL:
        s = rng.standard_normal(37).astype(np.float32)
        s[11] = v
        segs.append(s)
    segs.append(np.zeros(37, np.float32))
    return segs


def _same_class(a, b):
    """Equal numbers to rtol 1e-6; NaN against NaN, ±Inf against itself."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    assert np.array_equal(a[~fin & ~np.isnan(a)], b[~fin & ~np.isnan(b)])
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_health_word_matches_jax(dtype):
    for seg in _segments():
        j = j_guard.health_word(jnp.asarray(seg, jnp.dtype(dtype)))
        t = t_guard.health_word(torch.from_numpy(seg).to(
            getattr(torch, dtype)))
        assert t.dtype == torch.float32 and t.dim() == 0
        _same_class(t.numpy(), np.asarray(j))


def test_flags_match_jax():
    """Words and a chunk census holding NaN, ±Inf, 2^120 and zeros, under
    a scalar limit (bf16's, f32's and f16's inf) and a per-chunk one."""
    jcfg, tcfg = j_base.GuardConfig(), t_base.GuardConfig()
    cases = [np.array([1.0, 2.0, 0.0], np.float32),
             np.array([0.0, 0.0], np.float32)]
    for v in SPECIAL:
        cases.append(np.array([3.0, v, 1.0], np.float32))
    cases.append(np.array([2.0 ** 118, 2.0 ** 119 * 1.5, 5.0], np.float32))
    for wire in ("bfloat16", "float32", "float16"):
        limit = j_guard.overflow_limit(jcfg, wire)
        for c in cases:
            jf = j_guard.flags_from_census(jnp.asarray(c), limit)
            tf = t_guard.flags_from_census(torch.from_numpy(c), limit)
            assert (bool(tf.nonfinite), bool(tf.overflow)) == \
                (bool(jf.nonfinite), bool(jf.overflow)), (wire, c)
            words = [torch.tensor(x) for x in c]
            tw = t_guard.flags_from_words(words, limit)
            jw = j_guard.flags_from_words([jnp.float32(x) for x in c],
                                          limit)
            assert bool(t_guard.tripped(tw)) == bool(j_guard.tripped(jw))
            assert t_guard.as_metrics(tw)["guard_tripped"].item() == \
                float(j_guard.as_metrics(jw)["guard_tripped"])
    # Per chunk: a basis with zeros (padding) and a chunk 512x its basis.
    basis = np.array([0.0, 1.0, 2.0, 0.0, 4.0], np.float32)
    absolute = j_guard.overflow_limit(jcfg, "bfloat16")
    jl = j_guard.per_chunk_limit(jnp.asarray(basis), jcfg, absolute)
    tl = t_guard.per_chunk_limit(torch.from_numpy(basis), tcfg, absolute)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for census in (np.array([5.0, 511.0, 1023.0, 0.0, 3.0], np.float32),
                   np.array([5.0, 512.0, 1.0, 0.0, 3.0], np.float32),
                   np.array([2.0 ** 120, 1.0, 1.0, 0.0, 3.0], np.float32)):
        jf = j_guard.flags_from_census(jnp.asarray(census), jl)
        tf = t_guard.flags_from_census(torch.from_numpy(census), tl)
        assert (bool(tf.nonfinite), bool(tf.overflow)) == \
            (bool(jf.nonfinite), bool(jf.overflow)), census


# -- fault injection ----------------------------------------------------------

_BITS = {"float32": np.uint32, "bfloat16": np.uint16}
_SIGNED = {"float32": np.int32, "bfloat16": np.int16}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["nan", "overflow", "bitflip"])
def test_faults_match_jax(kind, dtype):
    """Each class at two offsets, one at the scheduled step and one at
    another step (not applied): bit for bit, NaN by class."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(200) * 0.5).astype(_NP[dtype])
    events = [j_faults.FaultEvent(step=3, kind=kind, offset=17, width=6),
              j_faults.FaultEvent(step=4, kind=kind, offset=90, width=9),
              j_faults.FaultEvent(step=3, kind=kind, offset=150, width=1)]
    t_events = [t_faults.FaultEvent(**dataclasses.asdict(e))
                for e in events]
    want = np.asarray(j_faults.apply_faults(jnp.asarray(x), jnp.int32(3),
                                            events))
    pool = torch.from_numpy(x.view(_SIGNED[dtype]).copy()).view(
        getattr(torch, dtype))
    got = t_faults.make_hook(t_events)(pool, 3)
    assert got.data_ptr() == pool.data_ptr()  # in place
    got_bits = got.view(getattr(torch, _SIGNED[dtype].__name__)).numpy() \
        .view(_BITS[dtype])
    want_bits = want.view(_BITS[dtype])
    nan = np.isnan(want.astype(np.float32))
    assert np.array_equal(np.isnan(got.float().numpy()), nan)
    assert nan.any() == (kind == "nan")
    np.testing.assert_array_equal(got_bits[~nan], want_bits[~nan])
    changed = got_bits != x.view(_BITS[dtype])
    assert changed[17:23].all() and changed[150] and not changed[90:99].any()


def test_unknown_fault_kind_raises():
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.apply_faults(torch.zeros(8), 0,
                              [t_faults.FaultEvent(step=0, kind="melt")])


@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_guard_lane_records_match_jax(mode):
    """The schedule of tests/test_guard.py: every class caught with a
    bit-identical skip, no false trip, and JAX's records exactly."""
    kw = [dict(step=2, kind="nan", offset=8, width=4),
          dict(step=5, kind="overflow", offset=40, width=4),
          dict(step=8, kind="bitflip", offset=100, width=6)]
    want = j_faults.GuardLane(mode=mode).run(
        11, [j_faults.FaultEvent(**k) for k in kw])
    lane = t_faults.GuardLane(mode=mode, device="cpu")
    got = lane.run(11, [t_faults.FaultEvent(**k) for k in kw])
    assert got == want
    assert t_faults.truth_table(got) == j_faults.truth_table(want)
    assert t_faults.truth_table(got)["false_trips"] == 0
    assert all(r["state_frozen"] for r in got) and got[-1]["skipped"] == 3
    # The windowed lane (tests/test_torch_window.py holds it against
    # JAX's windowed lane) gives the same records.
    assert lane.run(11, [t_faults.FaultEvent(**k) for k in kw],
                    window=2) == got


# -- the Trainer against JAX's ------------------------------------------------

STEPS = 4
GUARD = dict(init_scale=4.0, growth_interval=1000, min_scale=1.0)
FAULTS = [dict(step=1, kind="nan", offset=8, width=4),
          dict(step=2, kind="overflow", offset=64, width=4)]


def _cfg(base, get_smoke_fn, mode, overlap):
    """tests/test_guard.py's smoke run, with f32 compute so the two
    frameworks' losses can be held to 1e-5."""
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=4096, chunk_elems=512, sparsity=0.5,
            warmup_steps=0, wire_dtype="float32", overlap=overlap,
            guard=base.GuardConfig(**GUARD)),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.2, warmup_steps=1,
            total_steps=20, schedule="constant"),
        seq_len=32, global_batch=2, attn_chunk=0)


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (2, 33))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(mode, overlap):
    """(initial params, losses, scales, skips, tripped, final params)."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, mode, overlap),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    hook = j_faults.make_hook([j_faults.FaultEvent(**f) for f in FAULTS])
    out = {"losses": [], "scale": [], "skipped": [], "tripped": []}
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.array, state.params)
        step = trainer.build_train_step(donate=False, fault_hook=hook)
        for b in _batches():
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
            out["losses"].append(float(m["loss"]))
            out["tripped"].append(float(m["guard_tripped"]))
            out["scale"].append(float(state.guard.scale))
            out["skipped"].append(int(state.guard.skipped))
        final = jax.tree_util.tree_map(np.array, state.params)
    return init, out, final


@pytest.mark.parametrize("mode,overlap", [("lazy", "monolithic"),
                                          ("csc", "staged")])
def test_trainer_fault_hook_matches_jax(mode, overlap):
    init, want, j_final = _jax_run(mode, overlap)
    trainer = Trainer(_cfg(t_base, get_smoke, mode, overlap), device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    hook = t_faults.make_hook([t_faults.FaultEvent(**f) for f in FAULTS])
    step = trainer.build_train_step(fault_hook=hook)
    got = {"losses": [], "scale": [], "skipped": [], "tripped": []}
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        got["losses"].append(float(m["loss"]))
        got["tripped"].append(float(m["guard_tripped"]))
        got["scale"].append(float(state.guard.scale))
        got["skipped"].append(int(state.guard.skipped))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in ("scale", "skipped", "tripped"):
        assert got[k] == want[k], k
    assert got["tripped"] == [0.0, 1.0, 1.0, 0.0] and got["skipped"][-1] == 2
    final = convert.params_to_numpy(state.params)
    for a, b in zip(jax.tree_util.tree_leaves(final),
                    jax.tree_util.tree_leaves(j_final)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

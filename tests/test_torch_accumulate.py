"""Gradient accumulation (``TrainConfig.microbatches``) in the port's
Trainer against the JAX package's ``_accumulate``, on the CPU.

* The loss stream of ``microbatches`` 2 and 4 against the JAX Trainer's
  from the same weights on the same numpy batches, at rtol 1e-5 on an f32
  wire with f32 compute (the frameworks' f32 matmuls differ in the last
  bits, as in ``test_torch_trainer.py``): lazy and CSC, staged and
  monolithic; guarded with a NaN and an overflow injected (the same steps
  trip, the same scale and skip counts); int8; and olmo-smoke through
  blockwise attention. Where the wire is not quantized the final
  parameters agree to rtol 1e-5, atol 1e-6; the pool kernels launch once
  a step whatever the microbatches (the accumulation is autograd only).
* A microbatched window, and a pipelined one, give the eager microbatched
  steps' bits, a fault inside the window included.

JAX's ``_accumulate`` scans from zero accumulators that are not tagged
as varying over the data axis, which jax >= 0.7's shard_map type check
refuses ("scan body function carry input and carry output must have
equal types"). Its Trainer is therefore run here with that check off
(``check_vma=False`` on its shard_maps, a test-time patch; nothing in the
JAX package changes): on one data device the check changes no value.
"""
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.trainer as j_trainer_mod
from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.launch.mesh import make_host_mesh
from repro.parallel.collectives import compat_set_mesh
from repro.runtime import faults as j_faults
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.core.pool import flatten_tree
from repro_torch.kernels import ops
from repro_torch.launch.trainer import Trainer, is_flushed
from repro_torch.runtime import faults as t_faults

B, STEPS = 4, 4
GUARD = dict(init_scale=4.0, growth_interval=1000, min_scale=1.0)
FAULTS = [dict(step=1, kind="nan", offset=8, width=4),
          dict(step=2, kind="overflow", offset=64, width=4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small steps: one intra-op thread keeps them from oversubscribing
    the cores the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class Case:
    microbatches: int
    mode: str = "lazy"
    overlap: str = "staged"
    fmt: str = "native"
    guarded: bool = False
    arch: str = "smollm-135m"
    seq: int = 32
    attn_chunk: int = 0

    def __str__(self):
        return "-".join(str(v) for v in dataclasses.astuple(self))


CASES = [Case(2), Case(4), Case(2, "csc"), Case(4, "csc", "monolithic"),
         Case(2, "lazy", "monolithic"),
         Case(2, guarded=True), Case(4, "csc", guarded=True),
         Case(2, "lazy", "monolithic", guarded=True),
         Case(2, fmt="int8"), Case(2, "csc", "monolithic", "int8"),
         Case(2, arch="olmo-1b", seq=64, attn_chunk=32)]


def _cfg(base, get_smoke_fn, case, **over):
    model = dataclasses.replace(get_smoke_fn(case.arch)[0],
                                compute_dtype="float32")
    guard = base.GuardConfig(**GUARD) if case.guarded else None
    return base.TrainConfig(
        model=model, seq_len=case.seq, global_batch=B,
        microbatches=case.microbatches, attn_chunk=case.attn_chunk,
        gradientflow=base.GradientFlowConfig(
            mode=case.mode, bucket_elems=8192, wire_dtype="float32",
            chunk_elems=1024, sparsity=0.5, warmup_steps=1, warmup_stages=1,
            overlap=case.overlap, wire_format=case.fmt, guard=guard,
            **over),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
            weight_decay=1e-4, warmup_steps=2, total_steps=STEPS,
            schedule="warmup_cosine"))


def _batches(case, n=STEPS, seed=0):
    vocab = get_smoke(case.arch)[0].vocab_size
    toks = np.random.default_rng(seed).integers(0, vocab,
                                                (n, B, case.seq + 1))
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


@contextlib.contextmanager
def _jax_vma_check_off():
    real = j_trainer_mod.compat_shard_map
    with mock.patch.object(j_trainer_mod, "compat_shard_map",
                           lambda *a, **k: real(*a, **{**k,
                                                       "check_vma": False})):
        yield


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """(initial params, losses, tripped, scales, skipped, final params)."""
    with _jax_vma_check_off():
        trainer = j_trainer_mod.Trainer(
            _cfg(j_base, j_get_smoke, case), make_host_mesh(),
            j_get_smoke(case.arch)[1])
        hook = j_faults.make_hook([j_faults.FaultEvent(**f) for f in FAULTS]) \
            if case.guarded else None
        out = {"losses": [], "tripped": [], "scale": [], "skipped": []}
        fns = {}
        with compat_set_mesh(trainer.mesh):
            state = trainer.init_state(jax.random.PRNGKey(0))
            init = jax.tree_util.tree_map(np.array, state.params)
            for i, b in enumerate(_batches(case)):
                stage = trainer.gf.stage_for_step(i)
                if stage.index not in fns:
                    fns[stage.index] = trainer.build_train_step(
                        stage, donate=False, fault_hook=hook)
                state, m = fns[stage.index](state, jax.device_put(
                    {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
                out["losses"].append(float(m["loss"]))
                if case.guarded:
                    out["tripped"].append(float(m["guard_tripped"]))
                    out["scale"].append(float(state.guard.scale))
                    out["skipped"].append(int(state.guard.skipped))
            final = jax.tree_util.tree_map(np.array, state.params)
    return init, out, final


def _port_run(case, init):
    trainer = Trainer(_cfg(t_base, get_smoke, case, use_kernels=True),
                      device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    hook = t_faults.make_hook([t_faults.FaultEvent(**f) for f in FAULTS]) \
        if case.guarded else None
    out = {"losses": [], "tripped": [], "scale": [], "skipped": []}
    fns = {}
    ops.reset_counts()
    for i, b in enumerate(_batches(case)):
        stage = trainer.gf.stage_for_step(i)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage,
                                                        fault_hook=hook)
        state, m = fns[stage.index](state, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        if case.guarded:
            out["tripped"].append(float(m["guard_tripped"]))
            out["scale"].append(float(state.guard.scale))
            out["skipped"].append(int(state.guard.skipped))
    return trainer, state, out, dict(ops.dispatch_counts)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_accumulated_trainer_matches_jax(case):
    init, want, j_final = _jax_run(case)
    trainer, state, got, counts = _port_run(case, init)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert all(np.isfinite(got["losses"]))
    if case.guarded:
        for k in ("tripped", "scale", "skipped"):
            assert got[k] == want[k], k
        assert got["tripped"] == [0.0, 1.0, 1.0, 0.0]
    if case.fmt == "native":
        final = convert.params_to_numpy(state.params)
        for (name, a), (_, b) in zip(flatten_tree(final),
                                     flatten_tree(j_final)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg="/".join(name))
    # Accumulation is autograd only: one gradient pack and one master
    # pack a step, whatever the microbatches.
    assert counts["pool_pack.plain"] == 2 * STEPS


def test_accumulation_is_zeros_plus_slices_over_n(monkeypatch):
    """The accumulated gradient is, bit for bit, zeros plus each slice's
    gradient in order, divided by n; each metric the sum of value / n;
    guarded, each slice's loss carries the scale."""
    case = Case(4, guarded=True)
    trainer = Trainer(_cfg(t_base, get_smoke, case), device="cpu")
    state = trainer.init_state(0)
    batch = {k: torch.from_numpy(v) for k, v in _batches(case, 1)[0].items()}
    flat = trainer.pool.flat_leaves(state.params)
    scale = torch.tensor(4.0)
    got, metrics = trainer._grads(state.params, batch, scale)
    want = [torch.zeros_like(p) for p in flat]
    loss = torch.zeros(())
    for i in range(4):
        g, m = trainer._value_and_grad(
            flat, {k: v[i:i + 1] for k, v in batch.items()}, scale)
        want = [a + b for a, b in zip(want, g)]
        loss = loss + m["loss"] / 4
    for a, b in zip(got, want):
        assert torch.equal(a, b / 4)
    assert torch.equal(metrics["loss"], loss)
    assert set(metrics) == {"loss", "aux_loss"}


def test_microbatches_that_do_not_split_raise():
    case = Case(3)
    trainer = Trainer(_cfg(t_base, get_smoke, case), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(case, 1)[0].items()}
    with pytest.raises(ValueError, match="does not split"):
        trainer.build_train_step()(trainer.init_state(0), batch)
    with pytest.raises(ValueError, match="microbatches"):
        Trainer(_cfg(t_base, get_smoke, Case(0)), device="cpu")


def _flat(trainer, state):
    return [p.clone() for p in trainer.pool.flat_leaves(state.params)] + [
        state.opt.momentum.clone()]


@pytest.mark.parametrize("tail,guarded", [(0, False), (2, False),
                                          (0, True), (2, True)])
def test_microbatched_window_matches_eager_steps(tail, guarded):
    """A window of K = 4 steps at microbatches 2 (and, with a deferred
    tail of 2 buckets, the pipelined window) against four eager
    microbatched steps on the same batches: the same losses, the same
    parameters and momentum, bit for bit; guarded, a fault at step 2
    inside the window trips that step only."""
    case = Case(2, guarded=guarded)
    cfg = _cfg(t_base, get_smoke, case, pipeline_tail_buckets=tail,
               use_kernels=True)
    hook = t_faults.make_hook([t_faults.FaultEvent(step=2, kind="nan",
                                                   offset=8, width=4)]) \
        if guarded else None
    batches = _batches(case)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    win = Trainer(cfg, device="cpu")
    assert (win._pipeline_plan() is not None) == bool(tail)
    state, metrics = win.build_train_window(4, fault_hook=hook)(
        win.init_state(0), stacked)
    assert is_flushed(state) and state.step == 4
    eager = Trainer(_cfg(t_base, get_smoke, case, use_kernels=True),
                    device="cpu")
    ref = eager.init_state(0)
    step = eager.build_train_step(fault_hook=hook)
    losses, tripped = [], []
    for b in batches:
        ref, m = step(ref, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(m["loss"])
        if guarded:
            tripped.append(m["guard_tripped"])
    assert torch.equal(torch.stack(losses), metrics["loss"])
    if guarded:
        assert metrics["guard_tripped"].tolist() == [0, 0, 1, 0]
        assert torch.equal(torch.stack(tripped), metrics["guard_tripped"])
    for a, b in zip(_flat(win, state), _flat(eager, ref)):
        assert torch.equal(a, b)

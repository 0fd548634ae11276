"""The port's Trainer on the MoE, vlm and audio smoke configurations
against the JAX package's Trainer, on the CPU: the same weights and the
same numpy batches give the same loss and aux-loss streams (f32 wire, f32
compute, rtol 1e-5 as in ``test_torch_trainer.py``) and, off the low-bit
wires, the same final parameters (rtol 1e-5, atol 1e-6).

* grok1-, arctic-, internvl2- and musicgen-smoke, lazy and CSC;
* grok1-smoke and internvl2-smoke at ``microbatches=2`` (the vision
  embeddings split by rows with the tokens; MoE capacity per
  microbatch, as in JAX);
* grok1-smoke guarded with a NaN injected at step 1: that step trips in
  both packages, and the port's skip leaves parameters and momentum bit
  for bit as they were;
* a window of 3 steps (the vlm's float key and the audio (B, S, K)
  tokens in its stacked inputs) gives the eager steps' bits.

JAX's ``_accumulate`` needs its shard_maps' vma check off on jax >= 0.7
(see ``test_torch_accumulate.py``); on one data device that changes no
value.
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
from repro_torch.launch.trainer import Trainer
from repro_torch.runtime import faults as t_faults

B, S, STEPS = 4, 16, 3
GUARD = dict(init_scale=4.0, growth_interval=1000, min_scale=1.0)
FAULTS = [dict(step=1, kind="nan", offset=8, width=4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mode: str = "lazy"
    microbatches: int = 1
    guarded: bool = False

    def __str__(self):
        return "-".join(str(v) for v in dataclasses.astuple(self))


ARCHS = ("grok-1-314b", "arctic-480b", "internvl2-26b", "musicgen-large")
CASES = [Case(a, m) for a in ARCHS for m in ("lazy", "csc")] + [
    Case("grok-1-314b", microbatches=2), Case("internvl2-26b",
                                              microbatches=2),
    Case("grok-1-314b", guarded=True)]


def _cfg(base, get_smoke_fn, case, **over):
    model = dataclasses.replace(get_smoke_fn(case.arch)[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model, seq_len=S, global_batch=B,
        microbatches=case.microbatches, attn_chunk=0,
        gradientflow=base.GradientFlowConfig(
            mode=case.mode, bucket_elems=8192, wire_dtype="float32",
            chunk_elems=1024, sparsity=0.5, warmup_steps=1, warmup_stages=1,
            guard=base.GuardConfig(**GUARD) if case.guarded else None,
            **over),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
            weight_decay=1e-4, warmup_steps=2, total_steps=STEPS,
            schedule="warmup_cosine"))


def _batches(arch, n=STEPS, seed=0):
    cfg = get_smoke(arch)[0]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = (B, S + 1) + ((cfg.num_codebooks,)
                              if cfg.family == "audio" else ())
        toks = rng.integers(0, cfg.vocab_size, shape)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.standard_normal(
                (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.bfloat16) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i"
            else torch.from_numpy(v).to(torch.bfloat16)
            for k, v in b.items()}


@contextlib.contextmanager
def _jax_vma_check_off():
    real = j_trainer_mod.compat_shard_map
    with mock.patch.object(j_trainer_mod, "compat_shard_map",
                           lambda *a, **k: real(*a, **{**k,
                                                       "check_vma": False})):
        yield


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """(initial params, {losses, aux, tripped}, final params)."""
    with _jax_vma_check_off():
        trainer = j_trainer_mod.Trainer(
            _cfg(j_base, j_get_smoke, case), make_host_mesh(),
            j_get_smoke(case.arch)[1])
        hook = j_faults.make_hook([j_faults.FaultEvent(**f)
                                   for f in FAULTS]) \
            if case.guarded else None
        out = {"losses": [], "aux": [], "tripped": []}
        fns = {}
        with compat_set_mesh(trainer.mesh):
            state = trainer.init_state(jax.random.PRNGKey(0))
            init = jax.tree_util.tree_map(np.array, state.params)
            for i, b in enumerate(_batches(case.arch)):
                stage = trainer.gf.stage_for_step(i)
                if stage.index not in fns:
                    fns[stage.index] = trainer.build_train_step(
                        stage, donate=False, fault_hook=hook)
                state, m = fns[stage.index](state,
                                            jax.device_put(_jax_batch(b)))
                out["losses"].append(float(m["loss"]))
                out["aux"].append(float(m["aux_loss"]))
                if case.guarded:
                    out["tripped"].append(float(m["guard_tripped"]))
            final = jax.tree_util.tree_map(np.array, state.params)
    return init, out, final


def _snapshot(trainer, state):
    return [p.clone() for p in trainer.pool.flat_leaves(state.params)] + [
        state.opt.momentum.clone()]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_family_trainer_matches_jax(case):
    init, want, j_final = _jax_run(case)
    trainer = Trainer(_cfg(t_base, get_smoke, case, use_kernels=True),
                      device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    hook = t_faults.make_hook([t_faults.FaultEvent(**f) for f in FAULTS]) \
        if case.guarded else None
    got = {"losses": [], "aux": [], "tripped": []}
    fns = {}
    ops.reset_counts()
    for i, b in enumerate(_batches(case.arch)):
        stage = trainer.gf.stage_for_step(i)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage,
                                                        fault_hook=hook)
        before = _snapshot(trainer, state)
        state, m = fns[stage.index](state, _torch_batch(b))
        got["losses"].append(float(m["loss"]))
        got["aux"].append(float(m["aux_loss"]))
        if case.guarded:
            got["tripped"].append(float(m["guard_tripped"]))
            after = _snapshot(trainer, state)
            same = all(torch.equal(x, y) for x, y in zip(before, after))
            assert same == bool(got["tripped"][-1]), i
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    assert all(np.isfinite(got["losses"]))
    moe = get_smoke(case.arch)[0].moe is not None
    assert all((a > 0) == moe for a in got["aux"])
    if case.guarded:
        assert got["tripped"] == want["tripped"] == [0.0, 1.0, 0.0]
    final = convert.params_to_numpy(state.params)
    for (name, a), (_, b) in zip(flatten_tree(final), flatten_tree(j_final)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(name))
    # One gradient pack and one master pack a step.
    assert ops.dispatch_counts["pool_pack.plain"] == 2 * STEPS
    if case.mode == "csc":
        assert ops.dispatch_counts.get("chunk_l1norm.plain", 0) > 0


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-large"])
def test_window_takes_the_family_inputs(arch):
    """A window of 3 (stacked vision embeddings, or (3, B, S, K) tokens)
    against 3 eager steps: the same losses and parameters, bit for bit."""
    case = Case(arch)
    batches = [_torch_batch(b) for b in _batches(arch)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    cfg = _cfg(t_base, get_smoke, case, use_kernels=True)
    win = Trainer(cfg, device="cpu")
    state, metrics = win.build_train_window(3)(win.init_state(0), stacked)
    eager = Trainer(cfg, device="cpu")
    ref, step, losses = eager.init_state(0), eager.build_train_step(), []
    for b in batches:
        ref, m = step(ref, b)
        losses.append(float(m["loss"]))
    assert metrics["loss"].tolist() == losses
    for a, b in zip(_snapshot(win, state), _snapshot(eager, ref)):
        assert torch.equal(a, b)

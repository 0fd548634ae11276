"""The monolithic overlap path (``GradientFlowConfig(overlap=
"monolithic")``) and ``GradientFlow.reduce`` of the port against the JAX
package's, on the CPU: the reduction on one device (dense and lazy with
an f32 and a bf16 wire, prepacked or not; CSC's warm-up and a sparse
stage), the Trainer for momentum SGD, LARS and AdamW in both overlap
modes, and the port's staged path against its monolithic one.

Inputs are made with numpy from a seed and handed to both packages; the
port runs its kernels' plain versions (CPU tensors), JAX runs as its own
tests run it (one data device; psum is the identity).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.core import csc as j_csc
from repro.core.gradientflow import GFState as JGFState
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.parallel.collectives import compat_set_mesh, compat_shard_map
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.core import csc as t_csc
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool, flatten_tree
from repro_torch.kernels import ops
from repro_torch.launch.trainer import Trainer



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are small: one intra-op thread keeps them from
    oversubscribing the cores that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- GradientFlow.reduce on one device -----------------------------------------

SHAPES = {"a": (3, 7), "b": (40,), "c": (9, 9), "d": (33,), "e": (5, 13)}
CHUNK = 32


def _pools(pad):
    return (JPool({k: jnp.zeros(v) for k, v in SHAPES.items()}, pad_to=pad),
            GradientPool(SHAPES, pad_to=pad))


def _j_reduce(gf, g, state, stage, prepacked):
    """JAX's ``GradientFlow.reduce`` inside a size-1 data mesh."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((1,), ("data",))

    def f(g, hg, norms, residual):
        mean, mask, st = gf.reduce(g, JGFState(hg, norms, residual),
                                   stage=stage, prepacked=prepacked)
        return mean, mask, st.hg, st.chunk_norms, st.residual

    sm = compat_shard_map(f, mesh=mesh, in_specs=(P(None),) * 4,
                          out_specs=(P(None),) * 5, axis_names={"data"},
                          check_vma=False)
    with compat_set_mesh(mesh):
        return [np.asarray(x) for x in jax.jit(sm)(g, *state)]


def _check_reduce(jgf, tgf, g, jstate, tstate, jstage, tstage, prepacked,
                  dtype):
    want = _j_reduce(jgf, jnp.asarray(g, dtype[0]), jstate, jstage,
                     prepacked)
    mean, mask, st = tgf.reduce(torch.from_numpy(g).to(dtype[1]), tstate,
                                stage=tstage, prepacked=prepacked)
    assert mean.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(mean.numpy(), want[0])
    np.testing.assert_array_equal(mask.numpy(), want[1])
    np.testing.assert_array_equal(st.hg.numpy(), want[2])
    np.testing.assert_allclose(st.chunk_norms.numpy(), want[3], rtol=1e-6)
    assert st.residual.numel() == want[4].size == 0
    return mean, mask, st


@pytest.mark.parametrize("prepacked", [False, True])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_reduce_dense_lazy_matches_jax(mode, wire, prepacked):
    """The mean and the all-true mask, bit for bit; the state passes
    through. Prepacked pools arrive in the wire dtype and are reduced
    without a cast, the others in f32 and cast per bucket."""
    kw = dict(mode=mode, bucket_elems=96, wire_dtype=wire)
    jp, tp = _pools(1)
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jp, 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(**kw), tp, 1)
    assert len(tgf._lazy_bounds) > 1
    g = np.random.default_rng(0).standard_normal(tp.size).astype(np.float32)
    dtype = (jnp.dtype(wire), getattr(torch, wire)) if prepacked \
        else (jnp.float32, torch.float32)
    _check_reduce(jgf, tgf, g, jgf.init_state(), tgf.init_state(), None,
                  None, prepacked, dtype)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_reduce_csc_matches_jax(use_kernels):
    """CSC's dense warm-up (the hg-corrected pool, then the census) and a
    sparse stage (mean at the selected chunks, zero elsewhere), carried
    from one to the next: the mean, the mask and hg bit for bit, the
    census to 1e-6."""
    kw = dict(mode="csc", bucket_elems=96, chunk_elems=CHUNK, sparsity=0.5,
              warmup_steps=1, warmup_stages=1, wire_dtype="bfloat16")
    jp, tp = _pools(CHUNK)
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jp, 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(use_kernels=use_kernels,
                                                 **kw), tp, 1)
    assert [s.num_selected for s in tgf.stages] == [8, 4]
    rng = np.random.default_rng(1)
    jstate = jgf.init_state()
    # A pending hg, as after a sparse step, for the warm-up to absorb.
    hg = (rng.standard_normal(tp.size) * 0.1).astype(np.float32)
    jstate = jstate._replace(hg=jnp.asarray(hg))
    tstate = tgf.init_state()._replace(hg=torch.from_numpy(hg.copy()))
    f32 = (jnp.float32, torch.float32)
    ops.reset_counts()
    for step in range(3):
        g = rng.standard_normal(tp.size).astype(np.float32)
        stage = tgf.stage_for_step(step)
        jstage = jgf.stage_for_step(step)
        assert stage.num_selected == jstage.num_selected
        mean, mask, tstate = _check_reduce(jgf, tgf, g, jstate, tstate,
                                           jstage, stage, False, f32)
        jstate = jstate._replace(hg=jnp.asarray(tstate.hg.numpy()),
                                 chunk_norms=jnp.asarray(
                                     tstate.chunk_norms.numpy()))
        if step:
            assert not mask.all() and (mean[~mask] == 0).all()
    if use_kernels:
        assert ops.dispatch_counts == {"chunk_l1norm.plain": 3,
                                       "csc_compact.plain": 2}
    with pytest.raises(AssertionError, match="f32 pool"):
        tgf.reduce(torch.zeros(tp.size), tstate, prepacked=True)


# -- the Trainer ---------------------------------------------------------------

B, S, STEPS = 2, 32, 3
THETA, TCHUNK = 8192, 1024
LR = {"momentum_sgd": 0.1, "lars": 0.1, "adamw": 1e-3}


def _cfg(base, get_smoke_fn, optimizer, mode, overlap, use_kernels=False):
    """smollm-135m at smoke size, f32 wire. CSC: 1024-element chunks, one
    dense warm-up step, then k = 156 of 313."""
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=THETA, wire_dtype="float32",
            chunk_elems=TCHUNK, sparsity=0.5, warmup_steps=1,
            warmup_stages=1, overlap=overlap, use_kernels=use_kernels),
        optimizer=base.OptimizerConfig(
            name=optimizer, learning_rate=LR[optimizer], momentum=0.9,
            weight_decay=1e-4, warmup_steps=2, total_steps=STEPS,
            schedule="warmup_cosine"),
        seq_len=S, global_batch=B, attn_chunk=0)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (B, S + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(optimizer, mode, overlap):
    """(initial params, per-step CSC selections, losses, final params) of
    the JAX Trainer, each step under the stage ``stage_for_step`` picks."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, optimizer, mode, overlap),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    fns = {}
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.array, state.params)
        picks, losses = [], []
        for i, b in enumerate(_batches(STEPS)):
            stage = trainer.gf.stage_for_step(i)
            if mode == "csc":
                idx, _ = j_csc.select_chunks(state.gf.chunk_norms,
                                             stage.num_selected)
                picks.append(np.array(idx).tolist())
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                                 for k, v in b.items()})
            state, metrics = fns[stage.index](state, jb)
            losses.append(float(metrics["loss"]))
        final = jax.tree_util.tree_map(np.array, state.params)
    return init, picks, losses, final


def _torch_run(cfg, init, batches):
    """(trainer, per-step CSC selections, losses, final params)."""
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    fns = {}
    picks, losses = [], []
    for i, b in enumerate(batches):
        stage = trainer.gf.stage_for_step(i)
        if cfg.gradientflow.mode == "csc":
            idx, _ = t_csc.select_chunks(state.gf.chunk_norms,
                                         stage.num_selected)
            picks.append(idx.tolist())
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        state, metrics = fns[stage.index](state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return trainer, picks, losses, convert.params_to_numpy(state.params)


def _leaves(tree):
    return [("/".join(p), np.asarray(v)) for p, v in flatten_tree(tree)]


def expected_counts(trainer, steps):
    """The plain versions a CPU run of ``steps`` steps dispatches, from the
    step plans: 2 packs a step; SGD and LARS one update a span a step
    when staged, one a step when monolithic, AdamW none; CSC one census a
    step and one gather a sparse step."""
    gf = trainer.gf
    plans = [gf.plan(gf.stage_for_step(s)) for s in range(steps)]
    want = {"pool_pack.plain": 2 * steps}
    if trainer.opt_name != "adamw":
        want["pool_unpack_update.plain"] = steps \
            if gf.cfg.overlap == "monolithic" \
            else sum(len(p.update_spans) for p in plans)
    if gf.cfg.csc_enabled:
        want["chunk_l1norm.plain"] = steps
        want["csc_compact.plain"] = sum(not p.warmup for p in plans)
    return want


# f32 wire: the frameworks' f32 matmuls differ in the last bits, so rtol
# 1e-5 (atol 1e-6 for parameters near zero), as for the other Trainer
# tests; the CSC selections must be equal at every step. AdamW steps each
# element by lr * mu_hat / (sqrt(nu_hat) + eps), which divides a gradient
# error d by about 4 eps where |g| ~ eps: the frameworks' gradients there
# differ by ~1e-9 (an embedding element with g ~ 5e-8 differs by 2 %),
# which moves that parameter by a few percent of lr. So under AdamW
# 99.9 % of each leaf's elements must meet that tolerance and every
# element must lie within one lr of JAX's (a lost or doubled step on any
# element breaks it).
def _check_params(optimizer, got, want):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if optimizer != "adamw":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            continue
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.999, (name, close.size - close.sum())
        np.testing.assert_allclose(a, b, rtol=0, atol=LR["adamw"],
                                   err_msg=name)


@pytest.mark.parametrize("optimizer,mode,overlap", [
    ("lars", "lazy", "staged"), ("lars", "csc", "staged"),
    ("adamw", "csc", "staged"), ("momentum_sgd", "lazy", "monolithic"),
    ("lars", "csc", "monolithic"), ("adamw", "lazy", "monolithic")])
def test_trainer_matches_jax(optimizer, mode, overlap):
    init, j_picks, j_losses, j_final = _jax_run(optimizer, mode, overlap)
    ops.reset_counts()
    trainer, t_picks, t_losses, t_final = _torch_run(
        _cfg(t_base, get_smoke, optimizer, mode, overlap, use_kernels=True),
        init, _batches(STEPS))
    if mode == "csc":
        assert [len(p) for p in t_picks] == [313, 156, 156]
        assert t_picks == j_picks
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _check_params(optimizer, t_final, j_final)
    assert ops.dispatch_counts == expected_counts(trainer, STEPS)


@pytest.mark.parametrize("mode", ["lazy", "csc"])
@pytest.mark.parametrize("optimizer", ["momentum_sgd", "lars", "adamw"])
def test_staged_matches_monolithic(optimizer, mode):
    """Flipping ``overlap`` keeps the port's training trajectory (as
    ``tests/test_engine.py`` holds it for the JAX package): losses to
    1e-6, parameters to 1e-6, the optimizer state the same."""
    init = convert.params_to_numpy(
        Trainer(_cfg(t_base, get_smoke, optimizer, mode, "staged"),
                device="cpu").model.init_params(3, "cpu"))
    runs = []
    for overlap in ("staged", "monolithic"):
        cfg = _cfg(t_base, get_smoke, optimizer, mode, overlap,
                   use_kernels=True)
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(
            params=convert.params_from_numpy(init, "cpu"))
        losses = []
        for i, b in enumerate(_batches(4, seed=1)):
            step = trainer.build_train_step(trainer.gf.stage_for_step(i))
            state, metrics = step(state, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
            losses.append(float(metrics["loss"]))
        runs.append((losses, _leaves(convert.params_to_numpy(state.params)),
                     convert.opt_state_to_numpy(state.opt)))
    (la, pa, oa), (lb, pb, ob) = runs
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for (name, a), (_, b) in zip(pa, pb):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
    for field, a, b in zip(oa._fields, oa, ob):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                   err_msg=field)

"""The low-bit wires of the port (``repro_torch.core.wire``: int8 and
fp8-e4m3 words with per-chunk scales and error feedback) against the JAX
package's, on the CPU.

* Every function of ``core/wire.py`` against ``repro.core.wire`` on
  seeded inputs: the scales, the int8 and fp8 words, the error, the
  dequantized pool and segments bit for bit (``torch.round`` and
  ``jnp.round`` both round half to even; f32 division is IEEE in both);
  the census to 1e-6 (summation order).
* ``GradientFlow.reduce`` on int8 and fp8 in dense, lazy and CSC, with
  the guard's loss scale too: the mean, the residual and hg bit for bit
  from the same inputs and the same census; CSC's summed norms to 1e-6.
* The Trainer against JAX's, lazy and CSC x staged and monolithic x int8
  and fp8: the free-running losses to rtol 1e-5 and CSC's selection equal
  at every step; then each step again from JAX's state before it
  (``convert.gf_state_from_numpy`` and friends), its loss to 1e-6 and its
  residual, hg, chunk norms and parameters against JAX's after it. The
  two frameworks' f32 gradients differ in the last bits (up to 1.5e-5 of
  a chunk's range here), so an element whose scaled value lies that close
  to a rounding midpoint may round to the neighbouring grid word: its
  residual then differs by one grid step (a power of two times its
  chunk's scale, 1 for int8), and its parameter by the matching update.
  At most 1 % of the elements may so differ, each by one grid step; every
  other element's residual holds to 3e-5 of the values it came from, its
  parameter and momentum to rtol 1e-5.
* The error-feedback identity over 2 and 4 gloo ranks, lazy and CSC,
  ``flat`` and ``pallas_ring``, int8: what the wire delivered plus the
  change in every rank's residual equals what the ranks meant to send.
  The ring's result equals the flat sum bit for bit (the int8 grid is
  exact); per ROADMAP C the ring is held against the flat sum, not the
  JAX twin. gloo sums int8 words (and has no fp8, which the wire upcasts
  for every algorithm but the ring).
* ``GuardLane(mode, wire_format="int8")`` records equal to JAX's, field
  for field; the port's Trainer guarded on int8 (a NaN and an overflow
  injected) trips at exactly the faulted steps and leaves every tensor,
  the residual included, bit-identical; over 2 gloo ranks a guarded int8
  step issues the unguarded step's collectives.

The port runs its kernels' plain versions (CPU tensors); JAX runs as its
own tests run it (one data device, psum the identity).
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
from repro.core import wire as j_wire
from repro.core.gradientflow import GFState as JGFState
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.parallel.collectives import compat_set_mesh, compat_shard_map
from repro.runtime import faults as j_faults
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.core import csc as t_csc
from repro_torch.core import wire as t_wire
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.launch.trainer import Trainer, TrainState
from repro_torch.runtime import faults as t_faults
from test_torch_ring import spawn_ranks

FORMATS = ("int8", "fp8_e4m3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small steps: one intra-op thread keeps them from oversubscribing
    the cores the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _t2n(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy (fp8 as its bytes' e4m3 values)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


# -- core/wire.py function by function ----------------------------------------

CHUNK = 64


def _grads(seed, chunks=16):
    """Gradients across six decades, with a zero chunk (the scale floor)
    and values past the clip (they saturate into the residual)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(chunks * CHUNK) *
         rng.choice([1e-4, 1e-2, 1.0, 40.0], chunks * CHUNK))
    g[CHUNK:2 * CHUNK] = 0.0
    g[5 * CHUNK] = 1e4
    return g.astype(np.float32)


def test_resolve_and_specs_match_jax():
    assert t_wire.supported_formats() == j_wire.supported_formats()
    assert t_wire.resolve("native") is None and t_wire.resolve(None) is None
    for fmt in FORMATS:
        ts, js = t_wire.resolve(fmt), j_wire.resolve(fmt)
        assert (ts.name, ts.qmax, ts.integer_grid) == \
            (js.name, js.qmax, js.integer_grid)
        assert ts.dtype.itemsize == js.dtype.itemsize == 1
        assert t_wire.is_quantized(fmt)
        for n in (1, 2, 3, 8, 64, 600):
            assert t_wire.rank_clip(ts, n) == j_wire.rank_clip(js, n)
        for wd in ("bfloat16", "float32"):
            assert t_wire.wire_itemsize(fmt, wd) == 1
            assert t_wire.wire_itemsize("native", wd) == \
                j_wire.wire_itemsize("native", wd)
    assert (t_wire.WIRE_MARGIN, t_wire.SCALE_FLOOR) == \
        (j_wire.WIRE_MARGIN, j_wire.SCALE_FLOOR)
    with pytest.raises(ValueError, match="wire_format"):
        t_wire.resolve("int4")


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_functions_match_jax(fmt, shards):
    """Scales, words, error and dequantization bit for bit from the same
    census; the census itself to 1e-6 (summation order)."""
    ts, js = t_wire.resolve(fmt), j_wire.resolve(fmt)
    g = _grads(shards)
    t_census = t_wire.chunk_l1(torch.from_numpy(g), CHUNK).numpy()
    j_census = np.asarray(j_wire.chunk_l1(jnp.asarray(g), CHUNK))
    np.testing.assert_allclose(t_census, j_census, rtol=1e-6)
    census = j_census * shards  # as if summed over ``shards`` ranks
    tsc = t_wire.scales_from_census(torch.from_numpy(census),
                                    chunk_elems=CHUNK, num_shards=shards,
                                    spec=ts)
    jsc = j_wire.scales_from_census(jnp.asarray(census), chunk_elems=CHUNK,
                                    num_shards=shards, spec=js)
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(np.asarray(jsc)))
    assert tsc[1].item() == np.float32(t_wire.SCALE_FLOOR)
    out = torch.full((g.size,), 7.0)
    tq, terr = t_wire.quantize_pool(torch.from_numpy(g), tsc,
                                    chunk_elems=CHUNK, spec=ts,
                                    num_shards=shards, out=out)
    jq, jerr = j_wire.quantize_pool(jnp.asarray(g), jsc, chunk_elems=CHUNK,
                                    spec=js, num_shards=shards)
    assert tq.dtype == ts.dtype and terr is out
    np.testing.assert_array_equal(_bits(_t2n(tq)), _bits(np.asarray(jq)))
    np.testing.assert_array_equal(_bits(terr.numpy()),
                                  _bits(np.asarray(jerr)))
    clip = t_wire.rank_clip(ts, shards)
    assert np.abs(_t2n(tq).astype(np.float32)).max() == clip  # saturated
    np.testing.assert_array_equal(
        _bits(t_wire.dequantize_pool(tq, tsc, CHUNK).numpy()),
        _bits(np.asarray(j_wire.dequantize_pool(jq, jsc, CHUNK))))
    # Per-bucket dequantization of ring sums over spans that do and do not
    # align with the chunks.
    rng = np.random.default_rng(shards)
    for start, end in ((0, g.size), (5, 100), (64, 128), (70, 70 + 197),
                       (3, 9), (130, 1000), (1000, 1024)):
        np.testing.assert_array_equal(
            t_wire.segment_scales(tsc, start, end, CHUNK).numpy(),
            np.asarray(j_wire.segment_scales(jsc, start, end, CHUNK)))
        seg = rng.integers(-127, 128, end - start).astype(np.int8)
        for arr in (seg, seg.astype(np.float32)):
            got = t_wire.dequantize_segment(torch.from_numpy(arr.copy()),
                                            tsc, start, end, CHUNK)
            want = j_wire.dequantize_segment(jnp.asarray(arr), jsc, start,
                                             end, CHUNK)
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(np.asarray(want)))


def test_int8_words_stay_on_the_grid_over_ranks():
    """The rank clip: N ranks' int8 words sum inside ±127, so a ring's
    hop-by-hop requantization in int8 equals the exact sum."""
    spec = t_wire.resolve("int8")
    n = 8
    gs = [torch.from_numpy(_grads(10 + r)) for r in range(n)]
    census = sum(t_wire.chunk_l1(g, CHUNK) for g in gs)
    s = t_wire.scales_from_census(census, chunk_elems=CHUNK, num_shards=n,
                                  spec=spec)
    qs = [t_wire.quantize_pool(g, s, chunk_elems=CHUNK, spec=spec,
                               num_shards=n)[0] for g in gs]
    exact = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
    assert exact.abs().max() <= 127
    acc = qs[0]
    for q in qs[1:]:
        acc = (acc.to(torch.int32) + q.to(torch.int32)).to(torch.int8)
    assert torch.equal(acc.to(torch.int32), exact)


# -- GradientFlow.reduce ------------------------------------------------------

SHAPES = {"a": (3, 7), "b": (40,), "c": (9, 9), "d": (33,), "e": (5, 13)}
RCHUNK = 32


def _pools():
    return (JPool({k: jnp.zeros(v) for k, v in SHAPES.items()},
                  pad_to=RCHUNK),
            GradientPool(SHAPES, pad_to=RCHUNK))


def _check_residual(got, want, send):
    """The residual against JAX's jitted one. XLA's CPU jit contracts
    ``g - q * s`` into one fused multiply-add; the port rounds the
    product first, as the JAX functions do when run eagerly (held bit for
    bit above). So each element may differ by the product's rounding and
    the result's: at most 2^-22 of |send| + |residual|, ``send`` being
    the (unscaled) values that were quantized."""
    bound = 2.0 ** -22 * (np.abs(send) + np.abs(want))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _j_reduce(gf, g, state, stage, **kw):
    """JAX's ``GradientFlow.reduce`` inside a size-1 data mesh: (mean,
    mask, hg, chunk norms, residual) as numpy."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((1,), ("data",))
    extra = {k: v for k, v in kw.items() if v is not None}

    def f(g, hg, norms, residual, *vals):
        mean, mask, st = gf.reduce(g, JGFState(hg, norms, residual),
                                   stage=stage,
                                   **dict(zip(extra, vals)))
        return mean, mask, st.hg, st.chunk_norms, st.residual

    sm = compat_shard_map(f, mesh=mesh, in_specs=(P(None),) * 4 + tuple(
        P(None) if np.ndim(v) else P() for v in extra.values()),
        out_specs=(P(None),) * 5, axis_names={"data"}, check_vma=False)
    with compat_set_mesh(mesh):
        out = jax.jit(sm)(jnp.asarray(g), *[jnp.asarray(x) for x in state],
                          *[jnp.asarray(v) for v in extra.values()])
        return [np.asarray(x) for x in out]


@pytest.mark.parametrize("loss_scale", [None, 4.0])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", ["dense", "lazy"])
def test_reduce_dense_lazy_matches_jax(mode, fmt, loss_scale):
    """Two steps carrying the residual, with the census handed to both
    (the pack's) or, under the guard, the census sum and the loss scale
    (the residual stays unscaled): the mean bit for bit (so the words are
    the same), the residual to its rounding (``_check_residual``)."""
    kw = dict(mode=mode, bucket_elems=96, chunk_elems=RCHUNK,
              wire_format=fmt)
    jp, tp = _pools()
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jp, 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(**kw), tp, 1)
    assert tgf.num_chunks == jgf.num_chunks and len(tgf._lazy_bounds) > 1
    assert tgf.num_collectives() == jgf.num_collectives()
    assert tgf.wire_bytes_per_step() == jgf.wire_bytes_per_step()
    rng = np.random.default_rng(3)
    tstate = tgf.init_state()
    assert tstate.residual.shape == (tp.size,)
    for _ in range(2):
        g = (rng.standard_normal(tp.size) * 3).astype(np.float32)
        g[-RCHUNK // 2:] = 0.0  # the zero padding tail
        census = np.asarray(j_wire.chunk_l1(jnp.asarray(g), RCHUNK))
        key = dict(census=census) if loss_scale is None else dict(
            census_sum=census, loss_scale=np.float32(loss_scale))
        want = _j_reduce(jgf, g, [x.numpy() for x in tstate], None, **key)
        tkey = {k: torch.from_numpy(np.array(v)) for k, v in key.items()}
        send = g / (loss_scale or 1.0) + tstate.residual.numpy()
        mean, mask, tstate = tgf.reduce(torch.from_numpy(g.copy()), tstate,
                                        **tkey)
        np.testing.assert_array_equal(_bits(mean.numpy()), _bits(want[0]))
        assert mask.all() and want[1].all()
        _check_residual(tstate.residual.numpy(), want[4], send)
        assert np.abs(want[4]).max() > 0
    with pytest.raises(AssertionError, match="f32 pool"):
        tgf.reduce(torch.zeros(tp.size), tstate, prepacked=True)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_reduce_csc_matches_jax(fmt, use_kernels):
    """CSC's native warm-up, then sparse steps on the low-bit wire, each
    from the same state: the mean, the mask and hg bit for bit, the
    residual to its rounding (``_check_residual``; it moves at the
    selected chunks only); the summed norms, whose selected chunks carry
    the pre-quantization send census, to 1e-6."""
    kw = dict(mode="csc", bucket_elems=96, chunk_elems=RCHUNK, sparsity=0.5,
              warmup_steps=1, warmup_stages=1, wire_format=fmt)
    jp, tp = _pools()
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jp, 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(use_kernels=use_kernels,
                                                 **kw), tp, 1)
    rng = np.random.default_rng(4)
    tstate = tgf.init_state()
    for step in range(4):
        stage, jstage = tgf.stage_for_step(step), jgf.stage_for_step(step)
        assert stage.num_selected == jstage.num_selected
        assert tgf.num_collectives(stage) == jgf.num_collectives(jstage)
        assert tgf.wire_bytes_per_step(stage) == \
            jgf.wire_bytes_per_step(jstage)
        g = rng.standard_normal(tp.size).astype(np.float32)
        before = [x.clone() for x in tstate]
        want = _j_reduce(jgf, g, [x.numpy() for x in tstate], jstage)
        mean, mask, tstate = tgf.reduce(torch.from_numpy(g), tstate,
                                        stage=stage)
        for got, w in zip((mean, mask, tstate.hg), want):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(w))
        _check_residual(tstate.residual.numpy(), want[4],
                        g + before[0].numpy() + before[2].numpy())
        np.testing.assert_allclose(tstate.chunk_norms.numpy(), want[3],
                                   rtol=1e-6)
        moved = (tstate.residual != before[2]).view(-1, RCHUNK).any(1)
        if step == 0:
            assert mask.all() and not moved.any()  # native warm-up
        else:
            sel, _ = t_csc.select_chunks(before[1], stage.num_selected)
            assert not mask.all() and moved.nonzero()[:, 0].tolist() == \
                sel.tolist()


# -- the Trainer against JAX's ------------------------------------------------

B, S, STEPS = 2, 32, 3
THETA, TCHUNK = 8192, 1024
CASES = [(m, o, f) for m in ("lazy", "csc") for o in ("staged", "monolithic")
         for f in FORMATS]
# The two frameworks' f32 gradients of one step differ by up to 1.5e-5 of
# a chunk's range at this size (CSC, whose selected chunks carry hg), so
# the residual's continuous part is held to 3e-5 of it; a rounding flip
# is a whole grid step, 1/127 of the range or more for int8.
RES_RTOL = 3e-5


def _cfg(base, get_smoke_fn, mode, overlap, fmt, **gf):
    """smollm-135m at smoke size, f32 compute. CSC: 1024-element chunks,
    one dense warm-up step, then k = 156 of 313."""
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=THETA, wire_dtype="float32",
            chunk_elems=TCHUNK, sparsity=0.5, warmup_steps=1,
            warmup_stages=1, overlap=overlap, wire_format=fmt, **gf),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(mode, overlap, fmt):
    """JAX's run: its CSC selections, its losses and, before every step
    and after the last, its state as numpy (params, SGDState, GFState)."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, mode, overlap, fmt),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    fns, picks, losses, states = {}, [], [], []
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        for i, b in enumerate(_batches(STEPS)):
            states.append((_np_tree(state.params), _np_tree(state.opt),
                           _np_tree(state.gf)))
            stage = trainer.gf.stage_for_step(i)
            if mode == "csc":
                idx, _ = j_csc.select_chunks(state.gf.chunk_norms,
                                             stage.num_selected)
                picks.append(np.array(idx).tolist())
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, metrics = fns[stage.index](state, jax.device_put(
                {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
            losses.append(float(metrics["loss"]))
        states.append((_np_tree(state.params), _np_tree(state.opt),
                       _np_tree(state.gf)))
    return picks, losses, states


def _port_state(trainer, jstate, step):
    """The port's TrainState from JAX's (one data shard)."""
    params, opt, gf = jstate
    return TrainState(
        params=convert.params_from_numpy(params, "cpu"),
        opt=convert.opt_state_from_numpy("momentum_sgd", opt, "cpu"),
        gf=convert.gf_state_from_numpy(gf, "cpu"), step=step,
        staging=torch.zeros((trainer.pool.size,)))


def _check_step(fmt, got_res, want_res, scales, qmax):
    """The residual after one step from the same state: within RES_RTOL
    of the values it came from (the chunk's range, ``qmax`` grid steps,
    plus the residual), or, at no more than 1 % of the elements, one grid
    step apart (a power of two times the chunk's scale: the spacing of
    adjacent e4m3 words, or 1 for int8) to that tolerance. Returns the
    elements that rounded apart."""
    d = np.abs(got_res - want_res)
    tol = RES_RTOL * (np.abs(want_res) + qmax * scales)
    apart = d > tol
    assert apart.mean() <= 0.01, apart.sum()
    s = scales[apart]
    step = np.exp2(np.round(np.log2(d[apart] / s)))
    if fmt == "int8":
        assert (step == 1.0).all(), d[apart] / s
    assert (np.abs(d[apart] - step * s) <= tol[apart]).all(), (
        d[apart][:8], s[:8])
    return apart


@pytest.mark.parametrize("mode,overlap,fmt", CASES)
def test_trainer_matches_jax(mode, overlap, fmt):
    picks, losses, states = _jax_run(mode, overlap, fmt)
    cfg = _cfg(t_base, get_smoke, mode, overlap, fmt, use_kernels=True)
    spec = t_wire.resolve(fmt)
    # Free-running from JAX's initial parameters.
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(
        states[0][0], "cpu"))
    t_picks, t_losses = [], []
    for i, b in enumerate(_batches(STEPS)):
        stage = trainer.gf.stage_for_step(i)
        if mode == "csc":
            idx, _ = t_csc.select_chunks(state.gf.chunk_norms,
                                         stage.num_selected)
            t_picks.append(idx.tolist())
        state, m = trainer.build_train_step(stage)(state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        t_losses.append(float(m["loss"]))
    np.testing.assert_allclose(t_losses, losses, rtol=1e-5)
    if mode == "csc":
        assert [len(p) for p in t_picks] == [313, 156, 156]
        assert t_picks == picks
    # Each step again from JAX's state before it.
    seen = []
    trainer.gf.quantized_scales = lambda cs, f=trainer.gf.quantized_scales: \
        seen.append(f(cs)) or seen[-1]
    for i, b in enumerate(_batches(STEPS)):
        before = _port_state(trainer, states[i], i)
        stage = trainer.gf.stage_for_step(i)
        if mode == "csc":
            sel, _ = t_csc.select_chunks(before.gf.chunk_norms,
                                         stage.num_selected)
            scales = np.zeros(trainer.gf.num_chunks, np.float32)
            scales[sel.numpy()] = trainer.gf.quantized_scales(
                before.gf.chunk_norms[sel]).numpy()
        seen.clear()
        after, m = trainer.build_train_step(stage)(before, {
            k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), losses[i], rtol=1e-6)
        j_params, j_opt, j_gf = states[i + 1]
        want_res = np.asarray(j_gf.residual).reshape(-1)
        got_res = after.gf.residual.numpy()
        if mode == "lazy":
            (scales,) = [s.numpy() for s in seen]
        warm = mode == "csc" and trainer.gf.plan(stage).warmup
        if warm:  # native warm-up: the residual stays zero
            assert not got_res.any() and not want_res.any()
            apart = np.zeros(got_res.shape, bool)
        else:
            apart = _check_step(fmt, got_res, want_res,
                                np.repeat(scales, TCHUNK), spec.qmax)
            assert got_res.any()
        # Parameters and momentum in pool order, where ``apart`` lies:
        # only the elements that rounded apart may differ.
        pool = trainer.pool
        p_got = pool.pack(after.params, dtype=torch.float32)[0].numpy()
        p_want = pool.pack(convert.params_from_numpy(j_params, "cpu"),
                           dtype=torch.float32)[0].numpy()
        ok = np.isclose(p_got, p_want, rtol=1e-5, atol=1e-6)
        assert (ok | apart).all(), np.flatnonzero(~ok)[:8]
        m_ok = np.isclose(after.opt.momentum.numpy(),
                          np.asarray(j_opt.momentum), rtol=1e-5, atol=1e-6)
        assert (m_ok | apart).all()
        if mode == "csc":
            np.testing.assert_allclose(after.gf.chunk_norms.numpy(),
                                       j_gf.chunk_norms, rtol=1e-5)
            hg_want = np.asarray(j_gf.hg).reshape(-1)
            np.testing.assert_allclose(after.gf.hg.numpy(), hg_want,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(hg_want).max())


# -- without error feedback ---------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", ["dense", "lazy", "csc"])
def test_reduce_without_error_feedback_matches_jax(mode, fmt):
    """``error_feedback=False`` (the CLI's ``--no-error-feedback``): the
    state carries no residual (size 0, as in JAX) and three steps give
    JAX's mean (and CSC's mask and hg) bit for bit, CSC's summed norms to
    1e-6; the wire still rounds what it sends."""
    kw = dict(mode=mode, bucket_elems=96, chunk_elems=RCHUNK,
              wire_format=fmt, error_feedback=False)
    if mode == "csc":
        kw.update(sparsity=0.5, warmup_steps=1, warmup_stages=1)
    jp, tp = _pools()
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jp, 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(**kw), tp, 1)
    assert tgf.cfg.quantized and not tgf.cfg.feedback_enabled
    tstate = tgf.init_state()
    assert tstate.residual.numel() == jgf.init_state().residual.size == 0
    rng = np.random.default_rng(7)
    for step in range(3):
        g = (rng.standard_normal(tp.size) * 3).astype(np.float32)
        if mode == "csc":
            stage, jstage = tgf.stage_for_step(step), jgf.stage_for_step(step)
            want = _j_reduce(jgf, g, [x.numpy() for x in tstate], jstage)
            mean, mask, tstate = tgf.reduce(torch.from_numpy(g), tstate,
                                            stage=stage)
            np.testing.assert_array_equal(_bits(tstate.hg.numpy()),
                                          _bits(want[2]))
            np.testing.assert_allclose(tstate.chunk_norms.numpy(), want[3],
                                       rtol=1e-6)
        else:
            census = np.asarray(j_wire.chunk_l1(jnp.asarray(g), RCHUNK))
            want = _j_reduce(jgf, g, [x.numpy() for x in tstate], None,
                             census=census)
            mean, mask, tstate = tgf.reduce(
                torch.from_numpy(g.copy()), tstate,
                census=torch.from_numpy(census.copy()))
            # What arrives is the rounded pool, not the pool itself.
            assert not np.array_equal(mean.numpy(), g)
        np.testing.assert_array_equal(_bits(mean.numpy()), _bits(want[0]))
        np.testing.assert_array_equal(mask.numpy(), want[1])
        assert tstate.residual.numel() == want[4].size == 0


NO_EF_CASES = [("lazy", "staged", "int8"), ("lazy", "monolithic", "fp8_e4m3"),
               ("csc", "staged", "fp8_e4m3"), ("csc", "monolithic", "int8")]


@functools.lru_cache(maxsize=None)
def _jax_run_no_feedback(mode, overlap, fmt):
    """(initial params, CSC selections, losses) of the JAX Trainer with
    ``error_feedback=False``."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, mode, overlap, fmt,
                            error_feedback=False),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    fns, picks, losses = {}, [], []
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = _np_tree(state.params)
        assert state.gf.residual.size == 0
        for i, b in enumerate(_batches(STEPS)):
            stage = trainer.gf.stage_for_step(i)
            if mode == "csc":
                idx, _ = j_csc.select_chunks(state.gf.chunk_norms,
                                             stage.num_selected)
                picks.append(np.array(idx).tolist())
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, metrics = fns[stage.index](state, jax.device_put(
                {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}))
            losses.append(float(metrics["loss"]))
    return init, picks, losses


@pytest.mark.parametrize("mode,overlap,fmt", NO_EF_CASES)
def test_trainer_without_error_feedback_matches_jax(mode, overlap, fmt):
    """The Trainer with ``error_feedback=False``: the losses to rtol 1e-5
    (f32 compute and wire, as in ``test_trainer_matches_jax``), CSC's
    selections equal at every step, and no residual at any step."""
    init, picks, losses = _jax_run_no_feedback(mode, overlap, fmt)
    cfg = _cfg(t_base, get_smoke, mode, overlap, fmt, use_kernels=True,
               error_feedback=False)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    t_picks, t_losses = [], []
    for i, b in enumerate(_batches(STEPS)):
        stage = trainer.gf.stage_for_step(i)
        if mode == "csc":
            idx, _ = t_csc.select_chunks(state.gf.chunk_norms,
                                         stage.num_selected)
            t_picks.append(idx.tolist())
        state, m = trainer.build_train_step(stage)(state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        t_losses.append(float(m["loss"]))
        assert state.gf.residual.numel() == 0
    np.testing.assert_allclose(t_losses, losses, rtol=1e-5)
    assert t_picks == picks


# -- error feedback over gloo ranks -------------------------------------------

_EF_BODY = """
    from test_torch_wire import ef_rank_run
    np.savez(out, **ef_rank_run(rank, world))
"""


def ef_rank_run(rank, world, steps=3):
    """This rank's side of the error-feedback identity: for lazy and CSC
    under ``flat`` and ``pallas_ring``, int8, ``steps`` reduces of seeded
    gradients (each rank its own), saving what it meant to send, its new
    residual, the mean and the mask; the ring's mean also beside the flat
    sum of the same inputs."""
    chunk, nch = 64, 8
    pool = GradientPool({"a": (chunk * nch,)}, pad_to=chunk)
    out = {}
    for mode in ("lazy", "csc"):
        gfs = {}
        for algo in ("flat", "pallas_ring"):
            cfg = t_base.GradientFlowConfig(
                mode=mode, bucket_elems=2 * chunk, chunk_elems=chunk,
                sparsity=0.5, warmup_steps=0, momentum=1.0,
                wire_format="int8", collective_algo=algo)
            gfs[algo] = GradientFlow(cfg, pool, world)
        states = {a: gf.init_state() for a, gf in gfs.items()}
        rng = np.random.default_rng(3)
        for t in range(steps):
            g = rng.standard_normal((world, pool.size)).astype(np.float32)
            for algo, gf in gfs.items():
                st = states[algo]
                gt = torch.from_numpy(g[rank])
                send = gt + st.hg + st.residual if mode == "csc" \
                    else gt + st.residual
                mean, mask, states[algo] = gf.reduce(
                    gt.clone(), st, stage=gf.stages[-1])
                key = f"{mode}|{algo}|{t}"
                out[key + "|send"] = send.numpy()
                out[key + "|res"] = states[algo].residual.numpy()
                out[key + "|mean"] = mean.numpy()
                out[key + "|mask"] = mask.numpy()
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_error_feedback_identity_over_gloo_ranks(world, tmp_path):
    """N * mean (what the wire delivered, dequantized) equals the sum over
    ranks of send - new residual (what each rank meant to send, less the
    error it keeps) at every selected element, to f32 rounding; the ring
    on int8 words gives the flat sum's mean bit for bit."""
    ranks = spawn_ranks(tmp_path, _EF_BODY, world, timeout=600)
    for mode in ("lazy", "csc"):
        for algo in ("flat", "pallas_ring"):
            for t in range(3):
                key = f"{mode}|{algo}|{t}"
                mean = ranks[0][key + "|mean"]
                mask = ranks[0][key + "|mask"]
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[key + "|mean"], mean)
                delivered = sum(r[key + "|send"] - r[key + "|res"]
                                for r in ranks)
                np.testing.assert_allclose(world * mean[mask],
                                           delivered[mask], rtol=1e-5,
                                           atol=1e-4)
                if mode == "csc":
                    assert 0 < mask.sum() < mask.size
                if algo == "pallas_ring":
                    flat = ranks[0][f"{mode}|flat|{t}|mean"]
                    np.testing.assert_array_equal(_bits(mean), _bits(flat))


# -- the guard on the low-bit wires -------------------------------------------

LANE_FAULTS = [dict(step=2, kind="nan", offset=8, width=4),
               dict(step=4, kind="overflow", offset=40, width=4),
               dict(step=6, kind="bitflip", offset=100, width=6)]


@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_guard_lane_int8_records_match_jax(mode):
    """tests/test_wire.py's schedule on the int8 wire: every class caught
    with a bit-identical skip (the residual included), no false trip, and
    JAX's records field for field."""
    want = j_faults.GuardLane(mode=mode, wire_format="int8").run(
        8, [j_faults.FaultEvent(**k) for k in LANE_FAULTS])
    lane = t_faults.GuardLane(mode=mode, wire_format="int8", device="cpu")
    assert lane.pool.size % lane.CHUNK == 0
    got = lane.run(8, [t_faults.FaultEvent(**k) for k in LANE_FAULTS])
    assert got == want
    table = t_faults.truth_table(got)
    assert table == j_faults.truth_table(want)
    assert table["false_trips"] == 0
    for kind in ("nan", "overflow", "bitflip"):
        assert table["classes"][kind]["caught"] == 1, (kind, got)


GUARD = t_base.GuardConfig(init_scale=4.0, growth_interval=1000,
                           min_scale=1.0)
TRAIN_FAULTS = (t_faults.FaultEvent(step=1, kind="nan", offset=8, width=4),
                t_faults.FaultEvent(step=2, kind="overflow", offset=64,
                                    width=4))


@pytest.mark.parametrize("overlap", ["staged", "monolithic"])
@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_guarded_int8_trainer_skips_bit_identical(mode, overlap):
    """The port's Trainer, guarded on int8, a NaN at step 1 and 2^120 at
    step 2 (CSC: both sparse steps): exactly those steps trip, each leaves
    every parameter, momentum and GradientFlow tensor (the residual too)
    bit-identical, and the clean steps move the residual."""
    cfg = _cfg(t_base, get_smoke, mode, overlap, "int8", use_kernels=True,
               guard=GUARD)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=3)
    hook = t_faults.make_hook(TRAIN_FAULTS)
    scale = GUARD.init_scale
    for i, b in enumerate(_batches(4, seed=2)):
        stage = trainer.gf.stage_for_step(i)
        before = [x.clone() for x in trainer.pool.flat_leaves(state.params)
                  + list(state.opt) + list(state.gf)]
        state, m = trainer.build_train_step(stage, fault_hook=hook)(state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        after = trainer.pool.flat_leaves(state.params) + list(state.opt) \
            + list(state.gf)
        faulted = i in (1, 2)
        assert m["guard_tripped"].item() == float(faulted), i
        assert np.isfinite(m["loss"].item())
        if faulted:
            scale /= 2
            for x, y in zip(before, after):
                assert torch.equal(x.reshape(-1).view(torch.uint8),
                                   y.reshape(-1).view(torch.uint8)), i
        elif not (mode == "csc" and i == 0):  # CSC's step 0: warm-up
            assert not torch.equal(before[-1], state.gf.residual), i
        assert state.guard.scale.item() == scale
    assert state.guard.skipped.item() == 2


_COUNT_BODY = """
    from test_torch_wire import count_rank_run
    np.savez(out, **count_rank_run(rank))
"""


def count_rank_run(rank, steps=3):
    """This rank's guarded int8 run (a NaN at step 1 on rank 0 only) and
    its unguarded twin, lazy and CSC under flat and pallas_ring: the
    guard_tripped metrics, the parameters after each step, and the
    collectives each step issued (``dist.all_reduce`` calls and ring
    sends, counted by wrapping ``torch.distributed``)."""
    import torch.distributed as dist

    counted = {"all_reduce": 0, "isend": 0}
    originals = {k: getattr(dist, k) for k in counted}

    def counter(name):
        def call(*a, **k):
            counted[name] += 1
            return originals[name](*a, **k)
        return call

    out = {}
    for algo in ("flat", "pallas_ring"):
        for mode in ("lazy", "csc"):
            for guard in (GUARD, None):
                cfg = _cfg(t_base, get_smoke, mode, "staged", "int8",
                           use_kernels=True, guard=guard,
                           collective_algo=algo)
                cfg = cfg.replace(global_batch=2 * B)
                trainer = Trainer(cfg, device="cpu")
                state = trainer.init_state(seed=1)
                hook = t_faults.make_hook([t_faults.FaultEvent(
                    step=1, kind="nan", offset=8, width=4)]) \
                    if rank == 0 else None
                batches = _batches(2 * steps, seed=7)
                tripped, params, calls = [], [], []
                for s in range(steps):
                    step = trainer.build_train_step(
                        trainer.gf.stage_for_step(s), fault_hook=hook)
                    b = {k: torch.from_numpy(v)
                         for k, v in batches[2 * s + rank].items()}
                    for k in counted:
                        counted[k] = 0
                        setattr(dist, k, counter(k))
                    try:
                        state, metrics = step(state, b)
                    finally:
                        for k, f in originals.items():
                            setattr(dist, k, f)
                    calls.append([counted["all_reduce"], counted["isend"]])
                    tripped.append(float(metrics.get("guard_tripped",
                                                     -1.0)))
                    params.append(torch.cat(
                        [p.reshape(-1) for p in
                         trainer.pool.flat_leaves(state.params)]).numpy())
                tag = f"{algo}|{mode}|" + ("guarded" if guard else "plain")
                out[tag + "|tripped"] = np.asarray(tripped)
                out[tag + "|params"] = np.stack(params)
                out[tag + "|calls"] = np.asarray(calls)
    return out


def test_guarded_int8_issues_the_unguarded_collectives(tmp_path):
    """Two gloo ranks, int8, a NaN on rank 0 only: both ranks trip (the
    census sum carries it), keep the same parameters, and every guarded
    step issues exactly the unguarded step's all-reduces and ring sends."""
    r0, r1 = spawn_ranks(tmp_path, _COUNT_BODY, 2, timeout=600)
    for algo in ("flat", "pallas_ring"):
        for mode in ("lazy", "csc"):
            def get(rank, k):
                return rank[f"{algo}|{mode}|{k}"]
            for rank in (r0, r1):
                np.testing.assert_array_equal(get(rank, "guarded|tripped"),
                                              [0.0, 1.0, 0.0])
                p = get(rank, "guarded|params")
                np.testing.assert_array_equal(p[0], p[1])  # the skip
                assert not np.array_equal(p[1], p[2])
                calls = get(rank, "guarded|calls")
                np.testing.assert_array_equal(calls,
                                              get(rank, "plain|calls"))
                assert calls[:, 0].min() > 0
                assert (calls[:, 1].min() > 0) == (algo == "pallas_ring")
            np.testing.assert_array_equal(get(r0, "guarded|params"),
                                          get(r1, "guarded|params"))

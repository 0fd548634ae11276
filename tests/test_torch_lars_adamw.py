"""The port's LARS trust ratios and AdamW against the JAX package's, on
the CPU, with numpy inputs from a seed: ``LARSScaler.ratios`` /
``ratios_view`` / ``expand`` (a leaf with ||w|| = 0 and one with
||g|| = 0, the padding entry, a padding-only view), the CSC mask in the
norms (the staged CSC update reads the post-reduce pool, where unselected
chunks still hold local gradients; JAX reads a zero-filled pool), AdamW's
whole-pool and segment updates over several masked steps, and an AdamW
state carried across packages mid-run.

Tolerances: the norms are f32 reductions in another order, so rtol 1e-6.
AdamW's ``counts`` bit for bit and its moments and masters to rtol 1e-6;
the masters also to atol 1e-8 (about two ulps of a 0.05 step): PyTorch's
CPU ``sqrt`` is not correctly rounded at every input, so a step can
differ from XLA's in its last ulp, which is 1e-6 relative where
``master - step`` cancels to a small value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import base as j_base
from repro.core.pool import GradientPool as JPool
from repro.optim import adamw as j_adamw
from repro.optim.lars import LARSScaler as JLARS
from repro_torch import convert, optim
from repro_torch.configs import base as t_base
from repro_torch.core.pool import GradientPool
from repro_torch.optim.lars import LARSScaler

SHAPES = {"a": (3, 7), "b": (40,), "c": (9, 9), "d": (33,), "e": (5, 13)}
CHUNK = 32
THETA = 60  # 3 spans of leaves, then the padding-only span
KW = dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-4,
          lars_eta=0.001, lars_eps=1e-9, beta1=0.9, beta2=0.95, eps=1e-8)


def _pools():
    return (JPool({k: jnp.zeros(v) for k, v in SHAPES.items()},
                  pad_to=CHUNK), GradientPool(SHAPES, pad_to=CHUNK))


def _lars_inputs(seed=0):
    """Master and gradients over the padded pool; the first leaf's master
    and the third leaf's gradients are all zero (ratio 1.0), and the
    padding holds noise the ratios must ignore."""
    _, tp = _pools()
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(tp.size).astype(np.float32)
    grads = (rng.standard_normal(tp.size) * 1e-2).astype(np.float32)
    s0, s2 = tp.specs[0], tp.specs[2]
    master[s0.offset:s0.offset + s0.size] = 0.0
    grads[s2.offset:s2.offset + s2.size] = 0.0
    chunk_mask = rng.random(tp.size // CHUNK) < 0.5
    chunk_mask[0] = chunk_mask[1] = True  # the zero leaves stay selected
    return master, grads, np.repeat(chunk_mask, CHUNK)


def _spans(tp):
    spans = tp.bucket_boundaries(THETA)
    assert len(spans) == 4 and tp.bucket_view(*spans[-1]).num_tensors == 0
    return spans


@pytest.mark.parametrize("masked", [False, True])
def test_lars_ratios_match_jax(masked):
    jp, tp = _pools()
    master, grads, mask = _lars_inputs()
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = np.asarray(JLARS(jp).ratios(jnp.asarray(master),
                                       jnp.asarray(grads), jcfg, jm))
    lars = LARSScaler(tp)
    got = lars.ratios(torch.from_numpy(master), torch.from_numpy(grads),
                      tcfg, tm)
    assert got.dtype == torch.float32
    assert got.shape == (tp.num_tensors + 1,) and tp.padding > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # ||w|| = 0, ||g|| = 0 and the padding entry give exactly 1.0; the
    # other ratios are LARS's (below 1 here) unless the mask leaves a
    # leaf no gradient.
    assert got[0] == got[2] == got[-1] == 1.0
    others = got[[1, 3, 4]]
    assert ((others > 0) & (others <= 1.0)).all()
    assert masked or (others < 1.0).all()
    np.testing.assert_allclose(
        lars.expand(got).numpy(),
        np.asarray(JLARS(jp).expand(jnp.asarray(want))), rtol=1e-6)
    np.testing.assert_allclose(
        lars.scale(torch.from_numpy(master), torch.from_numpy(grads), tcfg,
                   tm).numpy(),
        np.asarray(JLARS(jp).scale(jnp.asarray(master), jnp.asarray(grads),
                                   jcfg, jm)), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_lars_ratios_view_match_jax(masked):
    """Per bucket view, from span-relative segments; the padding-only view
    gives an empty f32 vector."""
    jp, tp = _pools()
    master, grads, mask = _lars_inputs(1)
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    for s, e in _spans(tp):
        jv, tv = jp.bucket_view(s, e), tp.bucket_view(s, e)
        jm = jnp.asarray(mask[s:e]) if masked else None
        tm = torch.from_numpy(mask[s:e]) if masked else None
        want = np.asarray(JLARS(jp).ratios_view(
            jv, jnp.asarray(master[s:e]), jnp.asarray(grads[s:e]), jcfg, jm))
        got = LARSScaler(tp).ratios_view(
            tv, torch.from_numpy(master[s:e]), torch.from_numpy(grads[s:e]),
            tcfg, tm)
        assert got.dtype == torch.float32
        assert got.shape == (tv.num_tensors,) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_lars_csc_mask_closes_the_post_reduce_fault():
    """The staged CSC update hands LARS the post-reduce pool: the mean at
    the selected chunks, this rank's large local gradients elsewhere. JAX
    hands it a zero-filled pool. With the mask the port's ratios equal
    JAX's; without it they do not (the fault the mask closes)."""
    jp, tp = _pools()
    master, mean, mask = _lars_inputs(2)
    rng = np.random.default_rng(3)
    local = (rng.standard_normal(tp.size) * 10.0).astype(np.float32)
    post_reduce = np.where(mask, mean, local)   # the port's engine input
    zero_filled = np.where(mask, mean, 0.0).astype(np.float32)  # JAX's
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    unmasked = []
    for s, e in _spans(tp):
        jv, tv = jp.bucket_view(s, e), tp.bucket_view(s, e)
        want = np.asarray(JLARS(jp).ratios_view(
            jv, jnp.asarray(master[s:e]), jnp.asarray(zero_filled[s:e]),
            jcfg, jnp.asarray(mask[s:e])))
        args = (tv, torch.from_numpy(master[s:e]),
                torch.from_numpy(post_reduce[s:e]), tcfg)
        got = LARSScaler(tp).ratios_view(*args, torch.from_numpy(mask[s:e]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        unmasked.append((LARSScaler(tp).ratios_view(*args).numpy(), want))
    assert any(not np.allclose(a, b, rtol=1e-6) for a, b in unmasked)


def _adamw_inputs(n, seed):
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(n).astype(np.float32)
    grads = [(rng.standard_normal(n) * 1e-2).astype(np.float32)
             for _ in range(3)]
    masks = [rng.random(n) < f for f in (0.3, 0.6, 0.9)]
    scale = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return master, grads, masks, scale


def _check_adamw(t_master, t_state, j_master, j_state):
    np.testing.assert_array_equal(t_state.counts.numpy(),
                                  np.asarray(j_state.counts))
    for name, got, want, atol in (("master", t_master, j_master, 1e-8),
                                  ("mu", t_state.mu, j_state.mu, 0.0),
                                  ("nu", t_state.nu, j_state.nu, 0.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("with_scale", [False, True])
def test_adamw_update_pool_matches_jax(with_scale):
    """Three steps, a different random mask each, so the per-element
    counts (and bias corrections) differ; the inputs stay as they were."""
    n = 10_007
    master, grads, masks, scale = _adamw_inputs(n, 4)
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    j_master, j_state = jnp.asarray(master), j_adamw.init(n)
    t_master = torch.from_numpy(master)
    t_state = optim.init_state("adamw", n, "cpu")
    lr = np.float32(0.05)
    for g, m in zip(grads, masks):
        j_master, j_state = j_optim.update_pool(
            "adamw", j_master, jnp.asarray(g), j_state, jnp.asarray(m), jcfg,
            jnp.asarray(lr),
            scale=jnp.asarray(scale) if with_scale else None)
        before = [x.clone() for x in (t_master,) + tuple(t_state)]
        t_master2, t_state2 = optim.update_pool(
            "adamw", t_master, torch.from_numpy(g), t_state,
            torch.from_numpy(m), tcfg, torch.tensor(lr),
            scale=torch.from_numpy(scale) if with_scale else None,
            use_kernels=True)
        for x, y in zip(before, (t_master,) + tuple(t_state)):
            assert torch.equal(x, y)
        t_master, t_state = t_master2, t_state2
        _check_adamw(t_master, t_state, j_master, j_state)
    assert sorted(np.unique(t_state.counts.numpy())) == [0, 1, 2, 3]
    keep = ~masks[-1]
    np.testing.assert_array_equal(t_state.counts.numpy()[keep],
                                  (masks[0] & keep).astype(np.int32)[keep]
                                  + (masks[1] & keep)[keep])


def test_adamw_update_view_writes_state_in_place():
    """The engine's segment path: ``optim.update_view`` on each span's
    slices of the pool-sized state writes the moments, the counts and the
    parameter leaves in place, and equals JAX's ``optim.update_view``."""
    jp, tp = _pools()
    master, grads, masks, _ = _adamw_inputs(tp.size, 5)
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    state = optim.init_state("adamw", tp.size, "cpu")
    ptrs = [x.data_ptr() for x in state]
    leaves = [torch.from_numpy(master[s.offset:s.offset + s.size].copy())
              for s in tp.specs]
    pad = master[tp.unpadded_size:]  # no leaf: the master stays
    j_w, j_state = master, j_adamw.init(tp.size)
    for g, m in zip(grads, masks):
        t_w = torch.cat(leaves + [torch.from_numpy(pad)])
        j_leaves, j_segs = [], []
        for s, e in _spans(tp):
            jv, tv = jp.bucket_view(s, e), tp.bucket_view(s, e)
            jl, j_st = j_optim.update_view(
                "adamw", jv, jnp.asarray(j_w[s:e]), jnp.asarray(g[s:e]),
                j_adamw.AdamWState(*(x[s:e] for x in j_state)),
                jnp.asarray(m[s:e]), jcfg, jnp.float32(0.05))
            j_leaves += [np.asarray(x) for x in jl]
            j_segs.append(j_st)
            st_seg = optim.AdamWState(*(x[s:e] for x in state))
            out = leaves[tv.leaf_lo:tv.leaf_hi]
            t_leaves, t_st = optim.update_view(
                "adamw", tv, t_w[s:e], torch.from_numpy(g[s:e]), st_seg,
                torch.from_numpy(m[s:e]), tcfg, torch.tensor(0.05),
                use_kernels=True, out_leaves=out)
            assert all(a is b for a, b in zip(t_st, st_seg))
            assert len(t_leaves) == len(jl) == tv.num_tensors
            assert all(a.data_ptr() == b.data_ptr()
                       for a, b in zip(t_leaves, out))
        j_w = np.concatenate(j_leaves + [pad])
        j_state = j_adamw.AdamWState(*(jnp.concatenate(x)
                                       for x in zip(*j_segs)))
        _check_adamw(torch.cat(leaves + [torch.from_numpy(pad)]), state,
                     j_w, j_state)
    assert [x.data_ptr() for x in state] == ptrs
    assert int(state.counts.max()) == 3


def test_opt_state_carries_across_packages():
    """A mid-run AdamW state (counts differing under a chunk-granular CSC
    mask), carried from JAX to the port and back through numpy: one more
    step in each package agrees; SGD's state round-trips too."""
    n, chunk = 64 * 40, 64
    master, grads, _, _ = _adamw_inputs(n, 6)
    rng = np.random.default_rng(7)
    masks = [np.repeat(rng.random(n // chunk) < 0.5, chunk)
             for _ in range(4)]
    jcfg, tcfg = j_base.OptimizerConfig(**KW), t_base.OptimizerConfig(**KW)
    j_master, j_state = jnp.asarray(master), j_adamw.init(n)
    for g, m in zip(grads[:2] + grads[:1], masks[:3]):
        j_master, j_state = j_adamw.update_pool(
            j_master, jnp.asarray(g), j_state, jnp.asarray(m), jcfg,
            jnp.float32(0.05))
    assert len(np.unique(np.asarray(j_state.counts))) > 2
    t_state = convert.opt_state_from_numpy("adamw", j_state, "cpu")
    assert isinstance(t_state, optim.AdamWState)
    assert t_state.counts.dtype == torch.int32
    back = convert.opt_state_to_numpy(t_state)
    for a, b in zip(back, j_state):
        np.testing.assert_array_equal(a, np.asarray(b))
    g, m = grads[2], masks[3]
    j_master2, j_state2 = j_adamw.update_pool(
        j_master, jnp.asarray(g), j_state, jnp.asarray(m), jcfg,
        jnp.float32(0.05))
    t_master2, t_state2 = optim.update_pool(
        "adamw", torch.from_numpy(np.array(j_master)), torch.from_numpy(g),
        t_state, torch.from_numpy(m), tcfg, torch.tensor(0.05))
    _check_adamw(t_master2, t_state2, j_master2, j_state2)
    sgd = convert.opt_state_from_numpy(
        "lars", optim.SGDState(momentum=grads[0]), "cpu")
    assert isinstance(sgd, optim.SGDState)
    np.testing.assert_array_equal(convert.opt_state_to_numpy(sgd).momentum,
                                  grads[0])
    with pytest.raises(ValueError, match="unknown optimizer"):
        convert.opt_state_from_numpy("adam", j_state, "cpu")

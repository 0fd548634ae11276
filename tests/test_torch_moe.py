"""The port's MoE layer (``repro_torch.models.layers.moe``) against the
JAX package's ``models/layers/moe.py`` on the CPU.

* ``MoEConfig`` has the JAX package's fields and defaults.
* ``capacity`` is the reference's arithmetic (rounded up to 8).
* ``apply``'s output and aux loss from the same weights and inputs, with
  and without arctic's dense residual, at capacity factors 1.25 and 0.5
  (slots drop at both: the planted ties crowd experts 0 and 1), in f32 at
  rtol 1e-5: the routing (expert indices) and the dropped slots equal the
  reference's exactly. Ties are planted two ways: zero tokens (every
  router logit 0, so every expert ties and ``jax.lax.top_k`` takes the
  lowest indices) and two equal router columns (those two experts tie on
  every token).
* In bf16 (the router product in bf16, as on the training path) the
  expert indices agree on every token whose top-k margin exceeds 2^-6,
  and the output agrees within ``BF16_TOL`` of its largest value.
* The gradients with respect to the router, the experts, the residual
  MLP and the input against ``jax.grad`` (f32, rtol 1e-5, atol 1e-6 of
  the leaf's largest entry: a weight's gradient sums 64 tokens' terms of
  up to ~10, and the frameworks sum them in other orders, so an entry
  that nearly cancels differs by ~4e-7 of the largest).
* ``route`` breaks ties toward the lower expert index whatever the
  order ``torch.topk`` would give.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models.layers import moe as j_moe
from repro_torch.configs import base as t_base
from repro_torch.models.layers import moe

B, S, D, F, E, K, RF = 2, 32, 32, 48, 8, 2, 24
# Flat token ids set to zero: 16 of 64, enough to overflow experts 0 and 1
# at capacity factor 1.25 (24 slots each).
ZERO_TOKENS = (0, 3, 5, 6, 9, 17, 22, 23, 30, 35, 40, 41, 47, 52, 58, 63)
TIED = (3, 5)                            # experts with equal router columns
# bf16: each framework rounds the router product, the expert products and
# the combine to bf16 at its own points. Measured on the CPU over three
# seeds, with and without the residual: the routing the same on every
# token, 40-45 % of the outputs differ in some bit, by at most 0.0114 of
# the largest |y|; bound 2^-5 (0.031).
BF16_TOL = 2.0 ** -5


def _cfg(base, factor, residual):
    return base.ModelConfig(
        name="moe-test", family="moe", d_model=D, d_ff=F,
        moe=base.MoEConfig(num_experts=E, top_k=K, dense_residual=residual,
                           residual_d_ff=RF if residual else 0,
                           capacity_factor=factor))


def _inputs(residual, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])) \
            .astype(np.float32)
    params = {"router": w(D, E), "wi_gate": w(E, D, F), "wi_up": w(E, D, F),
              "wo": w(E, F, D)}
    params["router"][:, TIED[1]] = params["router"][:, TIED[0]]
    if residual:
        params["residual"] = {"wi_gate": w(D, RF), "wi_up": w(D, RF),
                              "wo": w(RF, D)}
    x = rng.standard_normal((B * S, D)).astype(np.float32)
    x[list(ZERO_TOKENS)] = 0.0
    return params, x.reshape(B, S, D)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _jax_routing(params, x, cfg):
    """The reference's expert indices and kept slots (its own lines, on
    its own arrays)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    cap = j_moe.capacity(cfg, t)
    logits = (x.reshape(t, -1) @ params["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    flat = idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32),
                     axis=0) - 1
    kept = jnp.take_along_axis(pos, flat[:, None], 1)[:, 0] < cap
    return np.asarray(idx), np.asarray(kept), np.asarray(logits)


def _port_routing(params, x, cfg):
    t = x.shape[0] * x.shape[1]
    logits = (x.reshape(t, -1) @ params["router"]).float()
    probs, _, idx = moe.route(logits, cfg.moe.top_k)
    _, kept = moe.slots(idx, cfg.moe.num_experts,
                        moe.capacity(cfg, t))
    return idx.numpy(), kept.numpy(), probs


def test_moe_config_matches_jax():
    j = {f.name: f.default for f in dataclasses.fields(j_base.MoEConfig)}
    t = {f.name: f.default for f in dataclasses.fields(t_base.MoEConfig)
         if f.name not in t_base.MoEConfig.PORT_FIELDS}
    assert t == j
    assert t_base.ModelConfig().moe is None


@pytest.mark.parametrize("tokens,factor", [(64, 1.25), (64, 0.5), (8, 1.0),
                                           (4096, 1.25), (1000, 0.3)])
def test_capacity_matches_jax(tokens, factor):
    j_cfg, t_cfg = (_cfg(b, factor, False) for b in (j_base, t_base))
    assert moe.capacity(t_cfg, tokens) == j_moe.capacity(j_cfg, tokens)
    assert moe.capacity(t_cfg, tokens) % 8 == 0


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_apply_matches_jax_f32(factor, residual):
    j_cfg, t_cfg = _cfg(j_base, factor, residual), _cfg(t_base, factor,
                                                         residual)
    params, x = _inputs(residual)
    j_params = _tree(jnp.asarray, params)
    t_params = _tree(torch.from_numpy, params)
    j_idx, j_kept, _ = _jax_routing(j_params, jnp.asarray(x), j_cfg)
    t_idx, t_kept, _ = _port_routing(t_params, torch.from_numpy(x), t_cfg)
    np.testing.assert_array_equal(t_idx, j_idx)
    # The planted ties: zero tokens go to experts 0 and 1.
    assert all(list(t_idx[i]) == [0, 1] for i in ZERO_TOKENS)
    # The tied pair at the top-k boundary: the lower index is taken.
    lo, hi = ((t_idx == e).any(1) for e in TIED)
    assert (lo & ~hi).any() and not (hi & ~lo).any()
    np.testing.assert_array_equal(t_kept, j_kept)
    assert not t_kept.all()  # slots drop at both factors
    j_y, j_aux = j_moe.apply(j_params, jnp.asarray(x), j_cfg)
    t_y, t_aux = moe.apply(t_params, torch.from_numpy(x), t_cfg)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    # A dropped slot adds nothing: without the residual, a token whose
    # slots all dropped comes out zero.
    dropped = torch.from_numpy(~t_kept.reshape(-1, K).any(1))
    if not residual:
        assert not t_y.reshape(-1, D)[dropped].any()


def test_route_ties_go_to_the_lower_index():
    """Equal probabilities in any position: the lower index first, as
    ``jax.lax.top_k`` orders them."""
    logits = torch.tensor([[0.0, 0.0, 0.0, 0.0],
                           [1.0, 2.0, 2.0, 2.0],
                           [3.0, 1.0, 3.0, 3.0],
                           [0.5, 0.5, 2.0, 0.5]])
    _, gates, idx = moe.route(logits, 2)
    j_idx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        logits.numpy()), axis=-1), 2)[1])
    assert idx.tolist() == j_idx.tolist() == [[0, 1], [1, 2], [0, 2],
                                              [2, 0]]
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("residual", [False, True])
def test_apply_matches_jax_bf16(residual):
    j_cfg, t_cfg = _cfg(j_base, 1.25, residual), _cfg(t_base, 1.25,
                                                      residual)
    params, x = _inputs(residual, seed=1)
    j_params = _tree(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    t_params = _tree(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                     params)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    j_idx, _, j_logits = _jax_routing(j_params, jx, j_cfg)
    t_idx, _, probs = _port_routing(t_params, tx, t_cfg)
    top = torch.sort(probs, -1, descending=True).values
    margin = (top[:, K - 1] - top[:, K]).numpy()
    clear = margin > 2.0 ** -6
    assert clear.sum() > len(clear) // 2
    np.testing.assert_array_equal(t_idx[clear], j_idx[clear])
    if (t_idx != j_idx).any():
        pytest.fail("a near-tied token routed differently; the output "
                    "comparison below would not be meaningful")
    j_y, j_aux = j_moe.apply(j_params, jx, j_cfg)
    t_y, t_aux = moe.apply(t_params, tx, t_cfg)
    want = np.asarray(j_y.astype(jnp.float32))
    got = t_y.float().numpy()
    assert got.dtype == want.dtype and t_y.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_gradients_match_jax(factor, residual):
    """d/d(router, experts, residual, x) of sum(y * r) + aux."""
    j_cfg, t_cfg = _cfg(j_base, factor, residual), _cfg(t_base, factor,
                                                         residual)
    params, x = _inputs(residual, seed=2)
    r = np.random.default_rng(3).standard_normal((B, S, D)) \
        .astype(np.float32)

    def j_loss(p, xx):
        y, aux = j_moe.apply(p, xx, j_cfg)
        return jnp.sum(y * r) + aux
    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(_tree(jnp.asarray, params),
                                                  jnp.asarray(x))
    t_params = _tree(lambda a: torch.from_numpy(a).requires_grad_(True),
                     params)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply(t_params, tx, t_cfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()

    def pairs(t, j, path=""):
        for k in t:
            if isinstance(t[k], dict):
                yield from pairs(t[k], j[k], f"{path}{k}/")
            else:
                yield f"{path}{k}", t[k].grad.numpy(), np.asarray(j[k])
    seen = []
    for name, got, want in pairs(t_params, j_gp):
        seen.append(name)
        top = np.abs(want).max()
        assert top > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * top,
                                   err_msg=name)
    assert "router" in seen and ("residual/wo" in seen) == residual
    want = np.asarray(j_gx)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())

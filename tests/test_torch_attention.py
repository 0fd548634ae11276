"""The port's attention, norms and feed-forward blocks against the JAX
package's: the same numpy-seeded inputs through both, compared at stated
tolerances. Blockwise attention in both forms (the lower-triangle pair
scan under ``causal_skip``, the masked full grid), causal and not, at f32
and bf16, with gradients; ``_pick_chunk`` and ``attend``'s dispatch and
its fallback to full attention."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models.layers import attention as j_attn
from repro.models.layers import mlp as j_mlp
from repro.models.layers import norms as j_norms
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention, mlp, norms

B, H, HD = 2, 4, 32

# f32: the frameworks' f32 products and exponentials differ in the last
# bits, and the online softmax adds them over a few blocks: rtol 1e-5,
# atol 1e-6 for entries near zero.
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16: the full grid is the same bits here. The causal_skip form casts
# its f32 accumulator to bf16 around every block step; XLA's CPU
# compiler keeps excess precision across that round trip (its default
# xla_allow_excess_precision) where the port rounds as written, so
# outputs differ by one bf16 ulp at most (measured: 2^-8 on 16 % of the
# elements of values up to 2.5). Bound: one ulp of the value (2^-7
# relative covers bf16's 8-bit mantissa at any magnitude), plus 2^-8.
BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -8)


def _qkv(s, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, sk or s, H, HD)).astype(np.float32)
    v = rng.standard_normal((B, sk or s, H, HD)).astype(np.float32)
    return q, k, v


def _to_jax(xs, dtype):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _to_torch(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_block_attend_matches_jax(masked):
    q, k, v = _qkv(64, seed=1)
    rng = np.random.default_rng(2)
    m = rng.standard_normal((B, H, 64)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, 64)).astype(np.float32)
    acc = rng.standard_normal((B, 64, H, HD)).astype(np.float32)
    mask = np.tril(np.ones((64, 64), bool)) if masked else None
    want = j_attn._block_attend(*_to_jax([q, k, v, m, l, acc], jnp.float32),
                                mask=None if mask is None
                                else jnp.asarray(mask))
    got = attention._block_attend(
        *_to_torch([q, k, v, m, l, acc], torch.float32),
        mask=None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,skip", [(True, True), (True, False),
                                         (False, False)])
def test_blockwise_attention_matches_jax(dtype, causal, skip):
    q, k, v = _qkv(256)
    want = j_attn.blockwise_attention(*_to_jax([q, k, v], getattr(jnp, dtype)),
                                      causal=causal, chunk_q=64, chunk_k=64,
                                      causal_skip=skip)
    got = attention.blockwise_attention(
        *_to_torch([q, k, v], getattr(torch, dtype)), causal=causal,
        chunk_q=64, chunk_k=64, causal_skip=skip)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 256, H, HD)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_blockwise_rectangular_chunks_match_jax():
    """Unequal query and key chunks (and lengths) take the full grid, as
    in JAX, even with causal_skip."""
    q, k, v = _qkv(128, sk=256, seed=3)
    want = j_attn.blockwise_attention(*_to_jax([q, k, v], jnp.float32),
                                      causal=True, chunk_q=64, chunk_k=128,
                                      causal_skip=True)
    got = attention.blockwise_attention(
        *_to_torch([q, k, v], torch.float32), causal=True, chunk_q=64,
        chunk_k=128, causal_skip=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_blockwise_forms_agree_with_full_attention():
    """Both blockwise forms equal full attention at f32 rounding, and each
    other."""
    q, k, v = _to_torch(_qkv(256, seed=4), torch.float32)
    full = attention.full_attention(q, k, v, causal=True)
    skip = attention.blockwise_attention(q, k, v, causal=True, chunk_q=64,
                                         chunk_k=64, causal_skip=True)
    grid = attention.blockwise_attention(q, k, v, causal=True, chunk_q=64,
                                         chunk_k=64, causal_skip=False)
    np.testing.assert_allclose(_np(skip), _np(full), **F32)
    np.testing.assert_allclose(_np(grid), _np(full), **F32)
    np.testing.assert_allclose(_np(skip), _np(grid), **F32)


@pytest.mark.parametrize("causal,skip", [(True, True), (True, False),
                                         (False, False)])
def test_blockwise_gradients_match_jax(causal, skip):
    q, k, v = _qkv(192, seed=5)
    rng = np.random.default_rng(6)
    cot = rng.standard_normal(q.shape).astype(np.float32)

    def j_loss(q_, k_, v_):
        out = j_attn.blockwise_attention(q_, k_, v_, causal=causal,
                                         chunk_q=64, chunk_k=64,
                                         causal_skip=skip)
        return jnp.sum(out * cot)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        *_to_jax([q, k, v], jnp.float32))
    tq, tk, tv = [x.requires_grad_(True)
                  for x in _to_torch([q, k, v], torch.float32)]
    out = attention.blockwise_attention(tq, tk, tv, causal=causal,
                                        chunk_q=64, chunk_k=64,
                                        causal_skip=skip)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


def test_pick_chunk_matches_jax():
    for s in list(range(1, 300)) + [1024, 4096, 4099, 8191]:
        for target in (64, 100, 128, 1024):
            assert attention._pick_chunk(s, target) == \
                j_attn._pick_chunk(s, target), (s, target)


@pytest.mark.parametrize("s,chunk,blockwise", [
    (256, 64, True),    # 4 blocks of 64
    (192, 128, True),   # the largest divisor below 128 is 96
    (72, 64, False),    # no divisor >= 64 at or below 64: full attention
    (131, 64, False),   # a prime: full attention
    (64, 64, False),    # not beyond the chunk: full attention
    (256, 0, False)])   # attn_chunk 0: full attention
def test_attend_dispatch_matches_jax(s, chunk, blockwise, monkeypatch):
    q, k, v = _qkv(s, seed=7)
    calls = []
    real = attention.blockwise_attention

    def spy(*a, **kw):
        calls.append((kw["chunk_q"], kw["chunk_k"]))
        return real(*a, **kw)

    monkeypatch.setattr(attention, "blockwise_attention", spy)
    want = j_attn.attend(*_to_jax([q, k, v], jnp.float32), causal=True,
                         attn_chunk=chunk, causal_skip=True)
    got = attention.attend(*_to_torch([q, k, v], torch.float32),
                           causal=True, attn_chunk=chunk, causal_skip=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert bool(calls) == blockwise, calls
    if blockwise:
        c = attention._pick_chunk(s, chunk)
        assert calls == [(c, c)]


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    q, k, v = _qkv(96, seed=8)
    want = j_attn._full_attention(*_to_jax([q, k, v], jnp.float32),
                                  causal=causal)
    got = attention.full_attention(*_to_torch([q, k, v], torch.float32),
                                   causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _cfg(**kw):
    base = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
                vocab_size=128, num_layers=1)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _params_like(j_spec, seed):
    """Random numpy arrays of the spec's shapes (ones-initialised scales
    would not test the affine terms)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s.shape).astype(np.float32) * 0.5 + 1.0
            for k, s in sorted(j_spec.items())}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm",
                                  "nonparametric_ln"])
def test_norms_match_jax(kind, dtype):
    j_cfg, t_cfg = _cfg(norm=kind)
    spec_j = j_norms.spec(j_cfg)
    assert sorted(norms.spec(t_cfg)) == sorted(spec_j)
    assert {k: v.shape for k, v in norms.spec(t_cfg).items()} == \
        {k: v.shape for k, v in spec_j.items()}
    params = _params_like(spec_j, 1)
    x = (np.random.default_rng(2).standard_normal((3, 5, 64)) * 3 + 1) \
        .astype(np.float32)
    want = j_norms.apply({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x).astype(getattr(jnp, dtype)), kind)
    got = norms.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x).to(getattr(torch, dtype)), kind)
    assert got.dtype == getattr(torch, dtype)
    # f32 rounding; bf16: the same f32 result rounded once more, so at
    # most one bf16 ulp where the f32 values straddle a rounding edge.
    tol = F32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_unknown_norm_raises():
    _, t_cfg = _cfg(norm="batchnorm")
    with pytest.raises(ValueError, match="unknown norm"):
        norms.spec(t_cfg)
    with pytest.raises(ValueError, match="unknown norm"):
        norms.apply({}, torch.zeros(2, 4), "batchnorm")


def test_rms_head_norm_matches_jax():
    rng = np.random.default_rng(3)
    scale = rng.standard_normal(HD).astype(np.float32)
    x = rng.standard_normal((B, 7, H, HD)).astype(np.float32) * 2
    want = j_norms.rms_head_norm(jnp.asarray(scale), jnp.asarray(x))
    got = norms.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(activation):
    """GeGLU and GELU ship in no configuration of the port yet: a
    hand-made one carries them."""
    j_cfg, t_cfg = _cfg(activation=activation)
    spec_j = j_mlp.spec(j_cfg)
    assert {k: v.shape for k, v in mlp.spec(t_cfg).items()} == \
        {k: v.shape for k, v in spec_j.items()}
    params = {k: v * 0.1 for k, v in _params_like(spec_j, 4).items()}
    x = np.random.default_rng(5).standard_normal((2, 6, 64)) \
        .astype(np.float32)
    want = j_mlp.apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), j_cfg)
    got = mlp.apply({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x), t_cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("attn_chunk,skip", [(0, True), (32, True),
                                             (32, False)])
def test_apply_train_matches_jax(qk_norm, attn_chunk, skip):
    """The projection (QK-norm before RoPE), GQA's repeated heads and the
    dispatch, through the layer's entry point."""
    j_cfg, t_cfg = _cfg(qk_norm=qk_norm)
    spec_j = j_attn.spec(j_cfg)
    assert {k: v.shape for k, v in attention.spec(t_cfg).items()} == \
        {k: v.shape for k, v in spec_j.items()}
    params = {k: v * (1.0 if k.endswith("norm") else 0.2)
              for k, v in _params_like(spec_j, 6).items()}
    x = np.random.default_rng(7).standard_normal((2, 128, 64)) \
        .astype(np.float32)
    want = j_attn.apply_train({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), j_cfg, attn_chunk=attn_chunk,
                              causal_skip=skip)
    got = attention.apply_train(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), t_cfg, attn_chunk=attn_chunk, causal_skip=skip)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_model_config_matches_jax_fields():
    """The port's ModelConfig has the JAX package's fields and defaults
    for what it carries, and ``supports_long_context``."""
    j_fields = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    for f in dataclasses.fields(ModelConfig):
        if f.name not in ModelConfig.PORT_FIELDS:
            assert j_fields[f.name] == f.default, f.name
    assert set(j_fields) == {f.name for f in dataclasses.fields(ModelConfig)
                             } - set(ModelConfig.PORT_FIELDS)
    for family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        assert ModelConfig(family=family).supports_long_context == \
            JModelConfig(family=family).supports_long_context

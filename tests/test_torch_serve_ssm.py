"""Serving of the recurrent families in the port (Mamba-1's and Mamba-2's
decode states and steps, ``MambaLM.serve_step``, ``HybridLM``'s
``HybridCache`` and ``serve_step``) against the JAX package's, on the
CPU. Weights, states and inputs from seeded numpy, carried over through
``convert`` (``test_torch_serve``'s helpers; a model's JAX ``serve_step``
under ``jax.jit``).

* ``mamba.init_state`` and ``mamba2.init_state`` equal to JAX's;
  ``mamba.apply_decode`` and ``mamba2.apply_decode`` (JAX's under
  ``jax.jit`` with excess precision off), 4 steps from random states:
  f32,
  the output and both state fields within 1e-5 of the largest |value|;
  a bf16 conv state (the serving cache's dtype) under f32 weights: the
  window, the output and the SSM state within BF16_CONV_TOL (one bf16
  step) of the largest |value|, a bound measured against JAX.
* ``MambaLM`` and ``HybridLM``: a prefill, then 4 decode steps, from
  random states (and, for the hybrid, random KV caches): logits and
  every cache field within 1e-5, the indices equal. The prefill returns
  the recurrent states bit-identical to those passed in (the JAX
  package's prefill fills no state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models.layers import mamba as j_mamba
from repro.models.layers import mamba2 as j_mamba2
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import build_model
from repro_torch.models.layers import mamba, mamba2
from test_torch_serve import (F32_TOL, _close, _params, _same_fields,
                              jax_layer, jax_serve_step)

# bf16 conv state, f32 weights. The decode conv's bf16 sum is JAX's bit
# for bit on equal windows (both accumulate the taps in f32 and round
# once), but the token's projection, f32 in both, rounds to a bf16 window
# entry one step apart where the two f32 products differ in their last
# bit. Measured over 8 steps from 3 seeds of the states and inputs
# (these weights): the windows within 1.1e-3, the outputs within 3.8e-5
# and the SSM states within 1.8e-4 of the largest |value|; the bound is
# one bf16 step at the top of the range.
BF16_CONV_TOL = 2.0 ** -8
B, PROMPT, STEPS = 2, 8, 4
LAYERS = {"mamba": (j_mamba, mamba, "falcon-mamba-7b"),
          "mamba2": (j_mamba2, mamba2, "zamba2-2.7b")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    return (dataclasses.replace(j_get_smoke(arch)[0], compute_dtype="float32"),
            dataclasses.replace(get_smoke(arch)[0], compute_dtype="float32"))


def _random(rng, abstract, dtype_of):
    """Random normal fields for a JAX state or cache of ShapeDtypeStructs
    (``dtype_of`` maps each field's dtype); index fields stay 0."""
    def leaf(s):
        if s.dtype == jnp.int32:
            return np.zeros(s.shape, np.int32)
        return rng.standard_normal(s.shape).astype(np.float32) \
            .astype(dtype_of(s.dtype))
    return jax.tree_util.tree_map(leaf, abstract)


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_decode_layer_matches_jax(name, conv_dtype):
    j_mod, t_mod, arch = LAYERS[name]
    j_cfg, t_cfg = _configs(arch)
    j_params, t_params = _params(j_mod.spec(j_cfg), seed=1)
    jd, td = getattr(jnp, conv_dtype), getattr(torch, conv_dtype)
    _same_fields(convert.cache_to_numpy(t_mod.init_state(t_cfg, B, td,
                                                         "cpu")),
                 jax.tree_util.tree_map(np.asarray, j_mod.init_state(
                     j_cfg, B, jd)), 0.0)
    rng = np.random.default_rng(0)
    cdt = getattr(ml_dtypes, conv_dtype) if conv_dtype == "bfloat16" \
        else np.float32
    state = _random(rng, j_mod.abstract_state(j_cfg, B, jd),
                    lambda d: cdt if d != jnp.float32 else np.float32)
    j_state = jax.tree_util.tree_map(jnp.asarray, state)
    t_state = convert.cache_from_numpy(state, "cpu")
    assert t_state.conv.dtype == td
    x = rng.standard_normal((B, STEPS, j_cfg.d_model)).astype(np.float32)
    tol = F32_TOL if conv_dtype == "float32" else BF16_CONV_TOL
    for t in range(STEPS):
        want, j_state = jax_layer(j_mod.apply_decode)(
            j_params, jnp.asarray(x[:, t:t + 1]), j_cfg, j_state)
        got, t_state2 = t_mod.apply_decode(t_params, torch.from_numpy(
            x[:, t:t + 1]), t_cfg, t_state)
        assert t_state2.ssm is t_state.ssm  # updated in place
        _close(got.numpy(), want, tol, f"out {t}")
        got_s = convert.cache_to_numpy(t_state)
        _close(got_s.conv, j_state.conv, tol, f"conv {t}")
        _close(got_s.ssm, j_state.ssm, tol, f"ssm {t}")


def _lm_run(arch):
    j_cfg, t_cfg = _configs(arch)
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params, t_params = _params(j_model.param_specs(), seed=2)
    rng = np.random.default_rng(3)
    max_len = PROMPT + STEPS
    cache = _random(rng, j_model.abstract_cache(B, max_len, jnp.float32),
                    lambda d: np.float32)
    toks = rng.integers(0, j_cfg.vocab_size, (B, max_len)).astype(np.int32)
    return j_model, t_model, j_params, t_params, cache, toks


def _states(cache):
    """The recurrent state fields of a port cache."""
    return list(cache.mamba if hasattr(cache, "mamba") else cache)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_lm_serve_step_matches_jax(arch):
    j_model, t_model, j_params, t_params, cache, toks = _lm_run(arch)
    j_cache = jax.tree_util.tree_map(jnp.asarray, cache)
    t_cache = convert.cache_from_numpy(cache, "cpu")
    before = [s.clone() for s in _states(t_cache)]
    kw = dict(mode="prefill")
    j_step = jax_serve_step(j_model)
    want, j_cache = j_step(
        j_params, {"tokens": jnp.asarray(toks[:, :PROMPT])}, j_cache,
        compute_dtype=jnp.float32, **kw)
    got, t_cache = t_model.serve_step(
        t_params, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, t_cache,
        compute_dtype=torch.float32, **kw)
    _close(got.numpy(), want, F32_TOL, "prefill logits")
    for a, b in zip(_states(t_cache), before):
        assert torch.equal(a, b)  # the prefill fills no recurrent state
    _same_fields(convert.cache_to_numpy(t_cache),
                 jax.tree_util.tree_map(np.asarray, j_cache), F32_TOL)
    for t in range(PROMPT, PROMPT + STEPS):
        tok = toks[:, t:t + 1]
        want, j_cache = j_step(
            j_params, {"tokens": jnp.asarray(tok)}, j_cache, mode="decode",
            compute_dtype=jnp.float32)
        got, t_cache = t_model.serve_step(
            t_params, {"tokens": torch.from_numpy(tok)}, t_cache,
            mode="decode", compute_dtype=torch.float32)
        _close(got.numpy(), want, F32_TOL, f"decode logits {t}")
        _same_fields(convert.cache_to_numpy(t_cache),
                     jax.tree_util.tree_map(np.asarray, j_cache), F32_TOL)
    assert not any(torch.equal(a, b) for a, b in
                   zip(_states(t_cache), before))

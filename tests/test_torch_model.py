"""The port's dense TransformerLM against the JAX package's: the same
weights (carried across with ``convert.params_from_numpy``) and the same
numpy batch give the same loss and the same gradient for every leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.parallel.sharding import init_params
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core.pool import flatten_tree
from repro_torch.models import build_model

B, S = 2, 32


def _setup():
    j_cfg, t_cfg = j_get_smoke("smollm-135m")[0], get_smoke("smollm-135m")[0]
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params = init_params(j_model.param_specs(), jax.random.PRNGKey(3))
    t_params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_params), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, t_cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return j_model, t_model, j_params, t_params, batch


def _jax_value_and_grad(model, params, batch, dtype, remat):
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}

    def loss(p):
        cp = jax.tree_util.tree_map(lambda x: x.astype(dtype), p)
        return model.loss_fn(cp, jb, remat=remat, attn_chunk=0,
                             compute_dtype=dtype)[0]
    return jax.value_and_grad(loss)(params)


def _torch_value_and_grad(model, params, batch, dtype, remat):
    flat = flatten_tree(params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
    tree = {}
    for (path, _), leaf in zip(flat, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf.to(dtype)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss_fn(tree, tb, remat=remat, attn_chunk=0,
                         compute_dtype=dtype)[0]
    grads = torch.autograd.grad(loss, leaves)
    return loss, {"/".join(p): g for (p, _), g in zip(flat, grads)}


# f32: the two frameworks' matmuls and reductions round differently in
# the last bits, so rtol 1e-5 (atol for entries near zero). bf16: every
# matmul output rounds to 8 bits of mantissa at framework-specific
# places, so the loss agrees to ~1e-2 relative and the gradients to a few
# percent of their largest entry.
TOL = {"float32": dict(loss_rtol=1e-5, grad_rtol=1e-5, grad_atol=1e-6),
       "bfloat16": dict(loss_rtol=2e-2, grad_rtol=0.0, grad_atol=None)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["layer", "none"])
def test_loss_and_grads_match_jax(dtype, remat):
    j_model, t_model, j_params, t_params, batch = _setup()
    j_loss, j_grads = _jax_value_and_grad(j_model, j_params, batch,
                                          getattr(jnp, dtype), remat)
    t_loss, t_grads = _torch_value_and_grad(t_model, t_params, batch,
                                            getattr(torch, dtype), remat)
    tol = TOL[dtype]
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=tol["loss_rtol"])
    j_flat = {"/".join(str(k.key) for k in path): np.asarray(g, np.float32)
              for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    assert set(j_flat) == set(t_grads)
    for name, want in j_flat.items():
        got = t_grads[name]
        assert got.dtype == torch.float32, name
        got = got.numpy()
        if tol["grad_atol"] is None:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=0.05 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=tol["grad_rtol"],
                                       atol=tol["grad_atol"], err_msg=name)


def test_convert_roundtrip():
    _, _, j_params, t_params, _ = _setup()
    back = convert.params_to_numpy(t_params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(j_params)[0],
            flatten_tree(back)):
        np.testing.assert_array_equal(np.asarray(a), b)

"""The port's dense architectures and shape cells against the JAX
package's: olmo-1b (non-parametric LayerNorm, tied embeddings),
stablelm-12b (LayerNorm, GQA) and qwen3-32b (QK-norm, GQA, head_dim 128)
beside smollm-135m.

* Every field of each ``CONFIG`` and ``SMOKE``, ``SHAPES``, ``shapes_for``
  and ``ALEXNET_GRAD_SHAPES``, equal to the JAX package's.
* The ``TransformerLM`` of each smoke configuration: the loss and every
  leaf's gradient from the same weights (``convert.params_from_numpy``)
  and the same numpy batch, at an ``attn_chunk`` below the sequence
  (blockwise attention), with and without ``causal_skip``.
* The parameter tree's empty subtrees (olmo's norms are ``{}``) survive
  ``flatten_tree``/``unflatten_tree`` and the gradient pool, as JAX's
  treedef keeps them.
* ``--attn-chunk`` and ``--no-error-feedback`` reach the ``TrainConfig``
  as the JAX CLI puts them there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.configs import shapes as j_shapes
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.parallel.sharding import abstract_params, init_params
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke, shapes
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import (GradientPool, flatten_tree, tree_def,
                                   unflatten_tree)
from repro_torch.models import build_model

NEW = ("olmo-1b", "stablelm-12b", "qwen3-32b")
B, S, CHUNK = 2, 128, 64


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_holds_every_dense_architecture():
    """Every dense architecture, in the JAX registry's order (the other
    families are held in test_torch_families.py and test_torch_ssm.py);
    an unknown one raises, naming ROADMAP.md."""
    dense = [a for a in J_ARCH_IDS if j_get_arch(a)[0].family == "dense"
             and j_get_arch(a)[0].moe is None]
    assert [a for a in ARCH_IDS if get_arch(a)[0].family == "dense"] == dense
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch("falcon-mamba-1b")


@pytest.mark.parametrize("arch", ["smollm-135m", *NEW])
def test_configs_match_jax(arch):
    for get_t, get_j in ((get_arch, j_get_arch), (get_smoke, j_get_smoke)):
        t_cfg, rules = get_t(arch)
        j_cfg, j_rules = get_j(arch)
        assert rules == dict(j_rules)  # the JAX package's rule table
        got = _fields(t_cfg)
        port = {k: got.pop(k) for k in ModelConfig.PORT_FIELDS}
        assert got == {k: getattr(j_cfg, k) for k in got}, arch
        # The port carries every field of the JAX config, and its own
        # fields (the port's architectures') at their defaults.
        assert set(got) == set(_fields(j_cfg)), arch
        assert port == {k: getattr(ModelConfig(), k)
                        for k in ModelConfig.PORT_FIELDS}, arch
        assert t_cfg.resolved_head_dim == j_cfg.resolved_head_dim
        assert t_cfg.supports_long_context == j_cfg.supports_long_context


def test_shapes_match_jax():
    assert list(shapes.SHAPES) == list(j_shapes.SHAPES)
    for name, cell in shapes.SHAPES.items():
        assert _fields(cell) == _fields(j_shapes.SHAPES[name]), name
    assert shapes.ALEXNET_GRAD_SHAPES == j_shapes.ALEXNET_GRAD_SHAPES
    assert sum(int(np.prod(s)) for s in shapes.ALEXNET_GRAD_SHAPES) == \
        62_378_344
    for arch in ARCH_IDS:
        cfg = get_arch(arch)[0]
        got = [c.name for c in shapes.shapes_for(cfg)]
        want = [c.name for c in j_shapes.shapes_for(j_get_arch(arch)[0])]
        long = ["long_500k"] if cfg.family in ("ssm", "hybrid") else []
        assert got == want == ["train_4k", "prefill_32k", "decode_32k"] \
            + long
    for family in ("ssm", "hybrid"):
        assert [c.name for c in shapes.shapes_for(ModelConfig(
            family=family))][-1] == "long_500k"


@pytest.mark.parametrize("arch", NEW)
def test_full_size_leaf_table_matches_jax(arch):
    """The full configuration's gradient pool: the JAX package's segment
    table, entry for entry (olmo-1b: 8 leaves, 1,176,764,416 elements,
    the first pool above 2^30 the port runs)."""
    t_pool = GradientPool(build_model(get_arch(arch)[0]).param_shapes())
    j_model = j_build_model(j_get_arch(arch)[0])
    j_pool = JPool(abstract_params(j_model.param_specs()))
    assert [(s.name, s.shape, s.offset) for s in t_pool.specs] == \
        [(s.name, tuple(s.shape), s.offset) for s in j_pool.specs]
    assert t_pool.size == j_pool.size
    if arch == "olmo-1b":
        assert t_pool.size == 1_176_764_416 and t_pool.num_tensors == 8


def _setup(arch, seed=3):
    j_cfg, t_cfg = j_get_smoke(arch)[0], get_smoke(arch)[0]
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params = init_params(j_model.param_specs(), jax.random.PRNGKey(seed))
    t_params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_params), device="cpu")
    toks = np.random.default_rng(0).integers(0, t_cfg.vocab_size,
                                             (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return j_model, t_model, j_params, t_params, batch


def _jax_value_and_grad(model, params, batch, causal_skip):
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}

    def loss(p):
        return model.loss_fn(p, jb, remat="layer", attn_chunk=CHUNK,
                             causal_skip=causal_skip,
                             compute_dtype=jnp.float32)[0]
    return jax.value_and_grad(loss)(params)


def _torch_value_and_grad(model, params, batch, causal_skip):
    flat = flatten_tree(params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
    tree = unflatten_tree(tree_def(params), leaves)
    loss = model.loss_fn(tree, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                         remat="layer", attn_chunk=CHUNK,
                         causal_skip=causal_skip,
                         compute_dtype=torch.float32)[0]
    grads = torch.autograd.grad(loss, leaves)
    return loss, {"/".join(p): g for (p, _), g in zip(flat, grads)}


# f32 compute: the frameworks' f32 products, exponentials and norms differ
# in the last bits; the loss agrees to rtol 1e-5 and each gradient to
# rtol 1e-5 with atol 1e-6 for entries near zero (test_torch_model.py's
# tolerance).
@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_model_loss_and_grads_match_jax(arch, causal_skip, monkeypatch):
    from repro_torch.models.layers import attention
    calls = []
    real = attention.blockwise_attention
    monkeypatch.setattr(attention, "blockwise_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    j_model, t_model, j_params, t_params, batch = _setup(arch)
    j_loss, j_grads = _jax_value_and_grad(j_model, j_params, batch,
                                          causal_skip)
    t_loss, t_grads = _torch_value_and_grad(t_model, t_params, batch,
                                            causal_skip)
    # Blockwise on every layer, forward and the remat recompute.
    assert len(calls) == 2 * get_smoke(arch)[0].num_layers
    assert all(k["chunk_q"] == CHUNK and k["causal_skip"] == causal_skip
               for k in calls)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    j_flat = {"/".join(str(k.key) for k in path): np.asarray(g)
              for path, g in jax.tree_util.tree_flatten_with_path(
                  j_grads)[0]}
    assert set(j_flat) == set(t_grads)
    for name, want in j_flat.items():
        np.testing.assert_allclose(t_grads[name].numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _skeleton(tree):
    return {k: _skeleton(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def test_empty_subtrees_survive_the_pool():
    """olmo-smoke's norms are ``{}``: flatten/unflatten, the pool's
    unflatten and its unravel return them, as JAX's pool does."""
    _, t_model, j_params, t_params, _ = _setup("olmo-1b")
    assert t_params["final_norm"] == {} and \
        t_params["layers"]["attn_norm"] == {} and \
        t_params["layers"]["mlp_norm"] == {}
    back = unflatten_tree(tree_def(t_params),
                          [v for _, v in flatten_tree(t_params)])
    assert _skeleton(back) == _skeleton(t_params) == tree_def(t_params)
    pool = GradientPool(t_model.param_shapes())
    assert pool.num_tensors == 8  # embed, 4 attention, 3 ffn; no norm
    tree = pool.unflatten(pool.flat_leaves(t_params))
    assert tree_def(tree) == tree_def(t_params)
    for (path, a), (_, b) in zip(flatten_tree(tree),
                                 flatten_tree(t_params)):
        assert a.data_ptr() == b.data_ptr(), path
    packed, _ = pool.pack(t_params, dtype=torch.float32)
    assert tree_def(pool.unravel(packed)) == tree_def(t_params)
    j_pool = JPool(j_params)
    j_tree = j_pool.unflatten([jnp.asarray(p.numpy().reshape(-1))
                               for p in pool.flat_leaves(t_params)])
    assert _skeleton(j_tree) == tree_def(tree)
    with pytest.raises(ValueError, match="fewer leaves"):
        unflatten_tree(tree_def(t_params), [torch.zeros(1)])
    with pytest.raises(ValueError, match="more leaves"):
        unflatten_tree({"a": {}, "b": None}, [torch.zeros(1)] * 2)


def test_cli_flags_match_jax(monkeypatch):
    """``--attn-chunk`` and ``--no-error-feedback`` parse into the
    TrainConfig as the JAX CLI's ``build`` puts them there, and the
    defaults (0, feedback on) agree."""
    from repro.launch import train as j_train
    from repro_torch.launch import train as t_train

    base = ["--arch", "olmo-1b", "--reduced", "--gf-mode", "lazy",
            "--wire-format", "int8"]
    for extra in ([], ["--attn-chunk", "32", "--no-error-feedback"]):
        j_args = j_train._parser().parse_args(base + extra + ["--mesh",
                                                              "1x1"])
        _, j_cfg, _ = j_train.build(j_args)
        t_args = t_train.parse_args(base + extra + ["--device", "cpu"])
        trainer, t_cfg = t_train.build(t_args)
        assert t_cfg.attn_chunk == j_cfg.attn_chunk == \
            (32 if extra else 0)
        assert t_cfg.gradientflow.error_feedback == \
            j_cfg.gradientflow.error_feedback == (not extra)
        assert t_cfg.microbatches == j_cfg.microbatches == 1
        assert trainer.gf.cfg.feedback_enabled == (not extra)


def test_cli_trains_olmo_smoke_blockwise():
    """The CLI on olmo-smoke through blockwise attention: finite losses,
    the window's state flushed, no restart."""
    from repro_torch.launch import train as t_train

    args = t_train.parse_args([
        "--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq-len", "64", "--attn-chunk", "32",
        "--gf-mode", "lazy", "--window-steps", "2", "--use-kernels"])
    trainer, losses, _, run = t_train.train(args)
    assert run["restarts"] == 0 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert trainer.cfg.attn_chunk == 32

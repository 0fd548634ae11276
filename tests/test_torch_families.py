"""The families built on ``TransformerLM`` in the port (moe: grok-1-314b
and arctic-480b; vlm: internvl2-26b; audio: musicgen-large) against the
JAX package's, on the CPU.

* Every field of each ``CONFIG`` and ``SMOKE`` equals the JAX package's;
  ``ARCH_IDS`` holds the JAX registry's ten ids in its order; an unknown
  architecture or family raises, naming ROADMAP.md.
* ``TransformerLM.loss_fn`` of each smoke configuration from the same
  weights (``convert``) and the same numpy batch: the loss, ``aux_loss``
  and every leaf's gradient in f32 (rtol 1e-5, atol 1e-6), with remat on
  and off, and blockwise attention for one of them. The audio family's
  unused ``tokens`` table gets a zero gradient, as in JAX.
* The full configurations, without allocating: the leaf table and the
  pool's buckets equal JAX's ``GradientPool``'s, the parameter count in
  ``tests/test_smoke_archs.py``'s range.
* ``input_specs`` equals JAX's for every ported architecture and the
  train, prefill and decode kinds; ``make_batch`` gives those shapes and
  dtypes from a ``torch.Generator``.
* ``SyntheticLM(num_codebooks=K)`` tiles tokens and labels over K.
* ``chip_smoke.step_flops`` counts the active MoE weights, the E x cap
  padded slots, the vision positions (backbone only) and K audio heads;
  for ssm no attention and no scan FLOPs, for hybrid the shared block
  once an application, its attention in ``groups`` layers and the SSD's
  products.
* The CLI trains grok1-, arctic- and musicgen-smoke and refuses
  internvl2-26b before any step (its stream has no vision_embeds).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.models import registry as j_registry
from repro.parallel.sharding import abstract_params, count_params, init_params
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.configs.base import (ModelConfig, MoEConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.pool import (GradientPool, flatten_tree, tree_def,
                                   unflatten_tree)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models import registry

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402

FAMILIES = ("grok-1-314b", "arctic-480b", "internvl2-26b", "musicgen-large")
B, S, CHUNK = 2, 32, 16
# tests/test_smoke_archs.py's parameter ranges for the full configs.
PARAM_RANGE = {"musicgen-large": (1e9, 4e9), "grok-1-314b": (250e9, 380e9),
               "arctic-480b": (380e9, 560e9),
               "internvl2-26b": (15e9, 30e9)}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_follows_jax_order():
    assert list(ARCH_IDS) == list(J_ARCH_IDS) and len(ARCH_IDS) == 10
    assert list(ARCH_IDS[:4]) == ["musicgen-large", "grok-1-314b",
                                  "arctic-480b", "internvl2-26b"]
    assert list(ARCH_IDS[-2:]) == ["falcon-mamba-7b", "zamba2-2.7b"]
    for arch in ("falcon-mamba-1b", "zamba3"):
        with pytest.raises(KeyError, match="ROADMAP"):
            get_arch(arch)
    for family in ("rwkv", "retnet"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(get_smoke("smollm-135m")[0],
                                            family=family))


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_match_jax(arch):
    for get_t, get_j in ((get_arch, j_get_arch), (get_smoke, j_get_smoke)):
        t_cfg, rules = get_t(arch)
        j_cfg, j_rules = get_j(arch)
        assert rules == dict(j_rules)  # the JAX package's rule table
        got, want = _fields(t_cfg), _fields(j_cfg)
        # The port's own fields (its architectures'), at their defaults.
        assert {k: got.pop(k) for k in ModelConfig.PORT_FIELDS} == \
            {k: getattr(ModelConfig(), k) for k in ModelConfig.PORT_FIELDS}
        assert set(got) == set(want)
        t_moe, j_moe = got.pop("moe"), want.pop("moe")
        assert got == want, arch
        assert (t_moe is None) == (j_moe is None)
        if t_moe is not None:
            got_moe = _fields(t_moe)
            assert {k: got_moe.pop(k) for k in MoEConfig.PORT_FIELDS} == \
                {k: getattr(MoEConfig(), k) for k in MoEConfig.PORT_FIELDS}
            assert got_moe == _fields(j_moe)


def _batch(cfg, rng, batch=B, seq=S):
    shape = (batch, seq + 1) + ((cfg.num_codebooks,)
                                if cfg.family == "audio" else ())
    toks = rng.integers(0, cfg.vocab_size, shape)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (batch, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch):
    """Integers as int32, floats as bf16 (the vision embeddings' dtype in
    ``input_specs``)."""
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.bfloat16) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i"
            else torch.from_numpy(v).to(torch.bfloat16)
            for k, v in batch.items()}


def _setup(arch, seed=3):
    j_cfg, t_cfg = j_get_smoke(arch)[0], get_smoke(arch)[0]
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params = init_params(j_model.param_specs(), jax.random.PRNGKey(seed))
    t_params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_params), device="cpu")
    return j_model, t_model, j_params, t_params, _batch(
        t_cfg, np.random.default_rng(0))


@pytest.mark.parametrize("arch,remat,chunk", [
    (a, r, 0) for a in FAMILIES for r in ("layer", "none")]
    + [("grok-1-314b", "layer", CHUNK), ("internvl2-26b", "none", CHUNK)])
def test_loss_and_grads_match_jax(arch, remat, chunk):
    j_model, t_model, j_params, t_params, batch = _setup(arch)

    def j_loss(p):
        return j_model.loss_fn(p, jax_batch(batch), remat=remat,
                               scan_layers=remat == "layer",
                               attn_chunk=chunk,
                               compute_dtype=jnp.float32)
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(j_params)
    flat = flatten_tree(t_params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
    t_total, t_metrics = t_model.loss_fn(
        unflatten_tree(tree_def(t_params), leaves), torch_batch(batch),
        remat=remat, attn_chunk=chunk, compute_dtype=torch.float32)
    grads = torch.autograd.grad(t_total, leaves, allow_unused=True)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(t_metrics[key].detach()),
                                   float(j_metrics[key]), rtol=1e-5)
    np.testing.assert_allclose(float(t_total.detach()), float(j_total),
                               rtol=1e-5)
    assert (float(t_metrics["aux_loss"]) > 0) == (arch in FAMILIES[:2])
    j_flat = {"/".join(str(k.key) for k in path): np.asarray(g)
              for path, g in jax.tree_util.tree_flatten_with_path(
                  j_grads)[0]}
    assert set(j_flat) == {"/".join(p) for p, _ in flat}
    for (path, _), g in zip(flat, grads):
        name = "/".join(path)
        if g is None:  # the audio family's unused 'tokens' table
            assert name == "embed/tokens" and arch == "musicgen-large"
            assert not j_flat[name].any()
            continue
        np.testing.assert_allclose(g.numpy(), j_flat[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_size_tables_match_jax(arch):
    """The leaf table (name, shape, offset), the pool's size and its
    buckets at 4 Mi elements and, padded to 32,768-element chunks, its
    size, equal to JAX's; nothing is allocated."""
    t_model = build_model(get_arch(arch)[0])
    j_specs = j_build_model(j_get_arch(arch)[0]).param_specs()
    for pad in (1, 32768):
        t_pool = GradientPool(t_model.param_shapes(), pad_to=pad)
        j_pool = JPool(abstract_params(j_specs), pad_to=pad)
        assert [(s.name, s.shape, s.offset) for s in t_pool.specs] == \
            [(s.name, tuple(s.shape), s.offset) for s in j_pool.specs]
        assert t_pool.size == j_pool.size
        assert t_pool.bucket_boundaries(1 << 22) == \
            j_pool.bucket_boundaries(1 << 22)
    lo, hi = PARAM_RANGE[arch]
    assert t_pool.unpadded_size == count_params(j_specs)
    assert lo < t_pool.unpadded_size < hi


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, kind):
    cfg = get_arch(arch)[0]
    t_specs = registry.input_specs(cfg, ShapeConfig(seq_len=64, kind=kind),
                                   2)
    j_specs = j_registry.input_specs(j_get_arch(arch)[0],
                                     JShapeConfig(seq_len=64, kind=kind), 2)
    assert list(t_specs) == list(j_specs)
    for name, (shape, dtype) in t_specs.items():
        assert shape == j_specs[name].shape, name
        assert str(dtype).split(".")[-1] == str(j_specs[name].dtype), name
    gen = torch.Generator().manual_seed(0)
    smoke = get_smoke(arch)[0]
    batch = registry.make_batch(smoke, ShapeConfig(seq_len=8, kind=kind), 2,
                                gen)
    for name, (shape, dtype) in registry.input_specs(
            smoke, ShapeConfig(seq_len=8, kind=kind), 2).items():
        assert batch[name].shape == shape and batch[name].dtype == dtype
        if not dtype.is_floating_point:
            assert 0 <= int(batch[name].min()) and \
                int(batch[name].max()) < smoke.vocab_size
    again = registry.make_batch(smoke, ShapeConfig(seq_len=8, kind=kind), 2,
                                torch.Generator().manual_seed(0))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


def test_vlm_attention_block_is_jax_choice():
    """internvl2-26b's 256 vision + 4096 text positions: 1024 does not
    divide 4352, and both packages' ``_pick_chunk`` take 544-position
    blocks."""
    from repro.models.layers import attention as j_attention
    from repro_torch.models.layers import attention

    seq = get_arch("internvl2-26b")[0].num_vision_tokens + 4096
    assert attention._pick_chunk(seq, 1024) == \
        j_attention._pick_chunk(seq, 1024) == 544


def test_make_batch_trains_the_vlm():
    """A make_batch batch (bf16 vision embeddings, int32 tokens) through
    the model: a finite loss, the vision positions dropped before the
    head."""
    cfg = get_smoke("internvl2-26b")[0]
    model = build_model(cfg)
    batch = registry.make_batch(cfg, ShapeConfig(seq_len=S), B,
                                torch.Generator().manual_seed(1))
    assert batch["vision_embeds"].shape == (B, 16, cfg.d_model)
    params = model.init_params(0, "cpu")
    loss, metrics = model.loss_fn(params, batch, compute_dtype=torch.float32)
    assert np.isfinite(float(loss)) and float(metrics["aux_loss"]) == 0.0
    with pytest.raises(ValueError, match="vision_embeds"):
        model.loss_fn(params, {k: batch[k] for k in ("tokens", "labels")})


def test_init_params_on_device_draws_there():
    """``on_device`` draws with a generator on the target device (fast on
    a card at billions of parameters); on the CPU that is the default
    draw, bit for bit."""
    model = build_model(get_smoke("arctic-480b")[0])
    a = flatten_tree(model.init_params(5, "cpu"))
    b = flatten_tree(model.init_params(5, "cpu", on_device=True))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_synthetic_codebooks_tile_as_jax():
    data = SyntheticLM(64, seed=2, num_codebooks=4)
    b = data.batch_numpy(3, 2, 8)
    plain = SyntheticLM(64, seed=2).batch_numpy(3, 2, 8)
    assert b["tokens"].shape == b["labels"].shape == (2, 8, 4)
    for k in range(4):
        np.testing.assert_array_equal(b["tokens"][..., k], plain["tokens"])
        np.testing.assert_array_equal(b["labels"][..., k], plain["labels"])
    assert SyntheticLM(64, num_codebooks=1).batch_numpy(0, 2, 8)[
        "tokens"].shape == (2, 8)


def _layer_weights(m):
    """One layer's matmul and norm weights, from the config's fields."""
    hd = m.resolved_head_dim
    attn = m.d_model * hd * (2 * m.num_heads + 2 * m.num_kv_heads)
    norms = {"rmsnorm": 2 * m.d_model, "layernorm": 4 * m.d_model}[m.norm]
    per = 3 if m.activation in ("swiglu", "geglu") else 2
    if m.moe is None:
        return attn + norms + per * m.d_model * m.d_ff, 0
    dense = attn + norms + m.d_model * m.moe.num_experts
    if m.moe.dense_residual:
        dense += 3 * m.d_model * m.moe.residual_d_ff
    return dense, 3 * m.d_model * m.d_ff  # (dense, one expert)


def _ssm_step_flops(m, rows):
    """(model, executed) for falcon-mamba-smoke or zamba2-smoke, counted
    from the config's fields."""
    d, ds, dc, v = m.d_model, m.ssm.d_state, m.ssm.d_conv, m.vocab_size
    di = 2 * d
    head = 6 * rows * v * d
    if m.family == "ssm":
        r = d // 16  # dt_rank
        layer = d + d * 2 * di + dc * di + di + di * (r + 2 * ds) \
            + r * di + di + di * ds + di + di * d
        w = rows * layer * m.num_layers
        return 6 * w + head, 8 * w + head  # the scan: no FLOPs
    h = di // m.ssm.head_dim
    layer = d + d * (2 * di + 2 * ds + h) + dc * (di + 2 * ds) \
        + (di + 2 * ds) + 3 * h + di + di * d
    hd = m.resolved_head_dim
    shared = 2 * d + d * hd * 2 * (m.num_heads + m.num_kv_heads) \
        + 3 * d * m.d_ff
    groups = m.num_layers // m.hybrid_attn_every
    backbone, shared = rows * layer * m.num_layers, rows * shared * groups
    attn = rows * S * m.num_heads * hd * groups
    q = S  # below the 128-position chunk
    causal = q * (ds + di) + 4 * di * ds
    full = 2 * q * (ds + di) + 4 * di * ds
    ssd = rows * m.num_layers
    return (6 * (backbone + shared) + head + 6 * attn + 3 * ssd * causal,
            10 * backbone + 8 * shared + head + 16 * attn + 5 * ssd * full)


@pytest.mark.parametrize("arch,microbatches", [
    ("grok-1-314b", 1), ("arctic-480b", 2), ("internvl2-26b", 1),
    ("musicgen-large", 2), ("smollm-135m", 1), ("falcon-mamba-7b", 1),
    ("zamba2-2.7b", 2)])
def test_step_flops_counts(arch, microbatches):
    m = get_smoke(arch)[0]
    cfg = TrainConfig(model=m, seq_len=S, global_batch=4,
                      microbatches=microbatches)
    got = chip_smoke.step_flops(cfg, GradientPool(
        build_model(m).param_shapes()))
    if m.family in ("ssm", "hybrid"):
        assert (got["model"], got["executed"]) == _ssm_step_flops(m, 4 * S)
        return
    L, hd = m.num_layers, m.resolved_head_dim
    seq = S + (m.num_vision_tokens if m.family == "vlm" else 0)
    rows, text = 4 * seq, 4 * S
    dense, expert = _layer_weights(m)
    heads = m.num_codebooks if m.family == "audio" else 1
    head = heads * m.vocab_size * m.d_model
    attn = rows * seq * m.num_heads * hd * L
    if m.moe is not None:
        e, k = m.moe.num_experts, m.moe.top_k
        cap = max(8, -(-int(rows // microbatches * k
                            * m.moe.capacity_factor / e) // 8) * 8)
        active = rows * k * expert * L
        slots = microbatches * e * cap * expert * L
        assert slots > active  # the padded slots cost more
    else:
        active = slots = 0
    assert got["model"] == 6 * (rows * dense * L + active) \
        + 6 * text * head + 6 * attn
    assert got["executed"] == 8 * (rows * dense * L + slots) \
        + 6 * text * head + 16 * attn


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "musicgen-large"])
def test_cli_trains_the_smoke_families(arch):
    from repro_torch.launch import train as t_train

    args = t_train.parse_args([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq-len", "16", "--chunk-elems", "512",
        "--csc-warmup", "2", "--window-steps", "2", "--use-kernels"])
    trainer, losses, _, run = t_train.train(args)
    assert run["restarts"] == 0 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert trainer.cfg.model.name == get_smoke(arch)[0].name


def test_cli_refuses_the_vlm():
    from repro_torch.launch import train as t_train

    args = t_train.parse_args(["--arch", "internvl2-26b", "--reduced",
                               "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="no vision_embeds"):
        t_train.train(args)

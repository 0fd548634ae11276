"""Serving in the port (the KV cache, prefill and decode, ``serve_step``
of the dense, moe, vlm and audio families, ``Trainer.build_serve_step``
and the serve CLI) against the JAX package's, on the CPU. Weights come
from seeded numpy through ``convert.params_from_numpy``, caches through
``convert.cache_from_numpy``, inputs from seeded numpy. JAX's functions
run under ``jax.jit`` (``jax_layer``, ``jax_serve_step``): eager, as
``tests/test_models.py`` runs them, JAX compiles every op (and a model's
layer scan at every call), which took these files past their time
budget; the arithmetic is the same, and f32 holds to 1e-5.

* f32 compute and caches: logits, outputs and every cache field within
  1e-5 of the tensor's largest |value|, the index exactly equal.
* ``attention.init_cache`` equal to JAX's; ``apply_prefill`` and
  ``apply_decode`` (naive and ``split_combine``, with and without
  QK-norm, GQA groups of 2) from a cache of random values, which the
  decode mask must hide; a decode
  past ``max_len``, where JAX's ``dynamic_update_slice`` clamps the
  write onto the last slot and the index runs on.
* ``TransformerLM.serve_step``: a prefill and 4 teacher-forced decode
  steps for dense, moe, audio (4 codebooks) and vlm (with the vision
  embeddings in the prefill, and text only); the port's decode of the
  prompt token by token equals its own prefill's logits (JAX's
  ``test_decode_matches_train_logits``, at its 5e-4).
* ``Trainer.build_serve_step`` against the JAX Trainer's (jitted, on a
  one-device mesh) for a dense and a hybrid smoke configuration: the
  values, the cache and the returned serving rules.
* The CLI returns (B, gen) or (B, gen, K) tokens equal to a greedy loop
  over the port's own ``serve_step`` from the same weights and prompts.
* ``cache_to_numpy(cache_from_numpy(x))`` keeps the bits of each cache
  type, bf16 fields included.
* ``rotary.apply_rope`` on (b, 1) decode positions equals JAX's.

The recurrent families' decode is in ``test_torch_serve_ssm.py``.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.models import build_model as j_build_model
from repro.models.layers import attention as j_attention
from repro.models.layers import mamba as j_mamba
from repro.models.layers import mamba2 as j_mamba2
from repro.models.layers import rotary as j_rotary
from repro.parallel.collectives import compat_set_mesh
from repro.parallel.sharding import abstract_params
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.pool import flatten_tree
from repro_torch.launch import serve
from repro_torch.launch.trainer import Trainer
from repro_torch.models import build_model
from repro_torch.models.layers import attention, rotary

F32_TOL = 1e-5
# JAX's own bound for a teacher-forced decode against the prefill.
TEACHER_TOL = 5e-4
B, PROMPT, STEPS = 2, 8, 4
FAMILIES = {"dense": "smollm-135m", "moe": "grok-1-314b",
            "audio": "musicgen-large", "vlm": "internvl2-26b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (name, err, top)


def _same_cache(got, want, tol=F32_TOL):
    """Each field of a port cache within ``tol`` of JAX's, the index
    exactly equal."""
    _same_fields(convert.cache_to_numpy(got),
                 jax.tree_util.tree_map(np.asarray, want), tol)


def _same_fields(got, want, tol):
    assert type(got).__name__ == type(want).__name__
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(g, tuple):
            _same_fields(g, w, tol)
        elif f == "index":
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, tol, f)


def _configs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(j_get_smoke(arch)[0], **kw),
            dataclasses.replace(get_smoke(arch)[0], **kw))


def _params(j_specs, seed=3):
    """(numpy weights, the port's): each leaf of the specs' shapes drawn
    from seeded numpy, a matrix N(0, 1 / fan-in), a vector uniform in
    [0.5, 1.5) (norm scales, biases, Mamba's A_log, D and dt_bias)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) < 2:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape)
                / np.sqrt(s.shape[-2])).astype(np.float32)
    j_params = jax.tree_util.tree_map(draw, abstract_params(j_specs))
    return j_params, convert.params_from_numpy(j_params, "cpu")


@functools.lru_cache(maxsize=None)
def jax_serve_step(model):
    """JAX's ``serve_step`` under ``jax.jit`` (one compile a mode and
    shape). Eager, its ``lax.scan`` over the layers is traced and
    compiled anew at every call (~0.5 s a decode step here)."""
    return jax.jit(model.serve_step, static_argnames=(
        "mode", "rules", "compute_dtype", "split_combine"))


@functools.lru_cache(maxsize=None)
def jax_layer(fn):
    """A JAX layer function ``fn(params, x, cfg, state, **kw)`` under
    ``jax.jit``, the config and keywords static: one compile a shape
    instead of eager JAX's compile of every op. Excess precision off, so
    XLA rounds each bf16 op as the code writes it, as eager JAX does
    (with it on, the jitted Mamba decode keeps the bf16 conv window's
    sum in f32)."""
    names = inspect.signature(fn).parameters
    return jax.jit(fn, static_argnums=(2,), static_argnames=[
        n for n in ("rules", "attn_chunk", "split_combine") if n in names],
        compiler_options={"xla_allow_excess_precision": False})


def test_rope_on_decode_positions_matches_jax():
    """(b, 1) positions (a decode step's, one a row) and the shared
    (s,) positions of the training path."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [7], [1000]], np.int32)
    want = j_rotary.apply_rope(jnp.asarray(x), *j_rotary.rope_tables(
        jnp.asarray(pos), 16, 10000.0))
    got = rotary.apply_rope(torch.from_numpy(x), *rotary.rope_tables(
        torch.from_numpy(pos), 16, 10000.0))
    _close(got.numpy(), want, F32_TOL, "rope (b, 1)")
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    want = j_rotary.apply_rope(jnp.asarray(x), *j_rotary.rope_tables(
        jnp.arange(5)[None, :].repeat(2, axis=0), 16, 10000.0))
    got = rotary.apply_rope(torch.from_numpy(x), *rotary.rope_tables(
        torch.arange(5), 16, 10000.0))
    _close(got.numpy(), want, F32_TOL, "rope (s,)")


def _random_cache(j_cfg, batch, max_len, rng):
    """A JAX KVCache of random k and v (index 0): every position the
    decode mask must hide holds a value."""
    shape = j_attention.abstract_cache(j_cfg, batch, max_len).k.shape
    return j_attention.KVCache(
        k=jnp.asarray(rng.standard_normal(shape), jnp.float32),
        v=jnp.asarray(rng.standard_normal(shape), jnp.float32),
        index=jnp.zeros((), jnp.int32))


def _attention_run(split_combine, qk_norm, prompt, max_len, steps):
    """Prefill then ``steps`` decodes in both packages, comparing each
    output and the cache after each call."""
    j_cfg, t_cfg = _configs("stablelm-12b", num_heads=4, num_kv_heads=2,
                            qk_norm=qk_norm)
    j_params, t_params = _params(j_attention.spec(j_cfg))
    _same_cache(attention.init_cache(t_cfg, B, max_len, torch.float32,
                                     "cpu"),
                j_attention.init_cache(j_cfg, B, max_len, jnp.float32), 0.0)
    rng = np.random.default_rng(1)
    j_cache = _random_cache(j_cfg, B, max_len, rng)
    t_cache = convert.cache_from_numpy(j_cache, "cpu")
    x = rng.standard_normal((B, prompt + steps, j_cfg.d_model)) \
        .astype(np.float32)
    want, j_cache = jax_layer(j_attention.apply_prefill)(
        j_params, jnp.asarray(x[:, :prompt]), j_cfg, j_cache)
    got, t_cache2 = attention.apply_prefill(t_params, torch.from_numpy(
        x[:, :prompt]), t_cfg, t_cache)
    assert t_cache2.k is t_cache.k and t_cache2.index is t_cache.index
    _close(got.numpy(), want, F32_TOL, "prefill")
    _same_cache(t_cache, j_cache)
    for t in range(prompt, prompt + steps):
        want, j_cache = jax_layer(j_attention.apply_decode)(
            j_params, jnp.asarray(x[:, t:t + 1]), j_cfg, j_cache,
            split_combine=split_combine)
        got, t_cache = attention.apply_decode(
            t_params, torch.from_numpy(x[:, t:t + 1]), t_cfg, t_cache,
            split_combine=split_combine)
        _close(got.numpy(), want, F32_TOL, f"decode {t}")
        _same_cache(t_cache, j_cache)
    return t_cache


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("split_combine", [False, True])
def test_attention_prefill_and_decode_match_jax(split_combine, qk_norm):
    cache = _attention_run(split_combine, qk_norm, PROMPT,
                           PROMPT + STEPS + 2, STEPS)
    assert int(cache.index) == PROMPT + STEPS


@pytest.mark.parametrize("split_combine", [False, True])
def test_decode_past_max_len_clamps_like_jax(split_combine):
    """8 prompt positions and 4 decodes into 10 slots: the last two
    decodes write slot 9 again (JAX's clamp), the index runs to 12 and
    the mask then admits every slot."""
    cache = _attention_run(split_combine, False, PROMPT, PROMPT + 2, STEPS)
    assert int(cache.index) == PROMPT + STEPS


def _family_inputs(j_cfg, rng, prompt, steps):
    tshape = (B, prompt + steps) + ((j_cfg.num_codebooks,)
                                    if j_cfg.family == "audio" else ())
    return rng.integers(0, j_cfg.vocab_size, tshape).astype(np.int32)


def _serve_pair(arch, vision, prompt=PROMPT, steps=STEPS, **kw):
    j_cfg, t_cfg = _configs(arch, **kw)
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params, t_params = _params(j_model.param_specs())
    rng = np.random.default_rng(2)
    toks = _family_inputs(j_cfg, rng, prompt, steps)
    extra = {}
    if vision:
        extra["vision_embeds"] = rng.standard_normal(
            (B, j_cfg.num_vision_tokens, j_cfg.d_model)).astype(np.float32)
    max_len = prompt + steps + (j_cfg.num_vision_tokens if vision else 0)
    return (j_cfg, t_cfg, j_model, t_model, j_params, t_params, toks, extra,
            max_len)


@pytest.mark.parametrize("family,vision", [
    ("dense", False), ("moe", False), ("audio", False), ("vlm", True),
    ("vlm", False)])
def test_serve_step_matches_jax(family, vision):
    (j_cfg, t_cfg, j_model, t_model, j_params, t_params, toks, extra,
     max_len) = _serve_pair(FAMILIES[family], vision)
    j_cache = j_model.init_cache(B, max_len, dtype=jnp.float32)
    t_cache = t_model.init_cache(B, max_len, dtype=torch.float32,
                                 device="cpu")
    _same_cache(t_cache, j_cache, 0.0)
    batch = {"tokens": toks[:, :PROMPT], **extra}
    j_step = jax_serve_step(j_model)
    want, j_cache = j_step(
        j_params, {k: jnp.asarray(v) for k, v in batch.items()}, j_cache,
        mode="prefill", compute_dtype=jnp.float32)
    got, t_cache = t_model.serve_step(
        t_params, {k: torch.from_numpy(v) for k, v in batch.items()},
        t_cache, mode="prefill", compute_dtype=torch.float32)
    assert not got.requires_grad
    _close(got.numpy(), want, F32_TOL, "prefill logits")
    _same_cache(t_cache, j_cache)
    for t in range(PROMPT, PROMPT + STEPS):
        tok = toks[:, t:t + 1]
        want, j_cache = j_step(
            j_params, {"tokens": jnp.asarray(tok)}, j_cache, mode="decode",
            compute_dtype=jnp.float32)
        got, t_cache = t_model.serve_step(
            t_params, {"tokens": torch.from_numpy(tok)}, t_cache,
            mode="decode", compute_dtype=torch.float32)
        _close(got.numpy(), want, F32_TOL, f"decode logits {t}")
        _same_cache(t_cache, j_cache)
    shape = (B, 1, j_cfg.num_codebooks, j_cfg.vocab_size) \
        if family == "audio" else (B, 1, j_cfg.vocab_size)
    assert tuple(got.shape) == shape


@pytest.mark.parametrize("split_combine", [False, True])
def test_teacher_forced_decode_matches_prefill(split_combine):
    """The port's own prefill logits against its decode of the same
    tokens one at a time (qwen3-smoke: QK-norm, GQA 8 / 2)."""
    _, t_cfg = _configs("qwen3-32b")
    model = build_model(t_cfg)
    params = model.init_params(0, torch.device("cpu"))
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, t_cfg.vocab_size, (B, 12)))
    kw = dict(compute_dtype=torch.float32)
    want, _ = model.serve_step(params, {"tokens": toks},
                               model.init_cache(B, 12, torch.float32, "cpu"),
                               mode="prefill", **kw)
    cache = model.init_cache(B, 12, torch.float32, "cpu")
    outs = []
    for t in range(12):
        lg, cache = model.serve_step(params, {"tokens": toks[:, t:t + 1]},
                                     cache, mode="decode",
                                     split_combine=split_combine, **kw)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(),
                               rtol=TEACHER_TOL, atol=TEACHER_TOL)


@functools.lru_cache(maxsize=None)
def _jax_serve_steps(arch):
    """The JAX Trainer's jitted prefill and decode on a one-device mesh,
    f32: (weights, tokens, [prefill logits, decode logits of each step],
    final cache, the prefill's and the decode's returned rules)."""
    j_cfg, _ = _configs(arch)
    trainer = JTrainer(JTrainConfig(model=j_cfg, global_batch=B,
                                    seq_len=PROMPT + STEPS),
                       make_host_mesh(), j_get_smoke(arch)[1])
    sc = JShapeConfig(name="serve", seq_len=PROMPT + STEPS,
                      global_batch=B, kind="decode")
    j_params, _ = _params(trainer.model.param_specs())
    toks = _family_inputs(j_cfg, np.random.default_rng(5), PROMPT, STEPS)
    with compat_set_mesh(trainer.mesh):
        prefill, p_rules = trainer.build_serve_step(sc, mode="prefill")
        decode, d_rules = trainer.build_serve_step(sc, mode="decode")
        cache = trainer.model.init_cache(B, PROMPT + STEPS,
                                         dtype=jnp.float32)
        lg, cache = prefill(j_params, {"tokens": jnp.asarray(
            toks[:, :PROMPT])}, cache)
        outs = [np.asarray(lg)]
        for t in range(PROMPT, PROMPT + STEPS):
            lg, cache = decode(j_params, {"tokens": jnp.asarray(
                toks[:, t:t + 1])}, cache)
            outs.append(np.asarray(lg))
        cache = jax.tree_util.tree_map(np.asarray, cache)
    return j_params, toks, outs, cache, (p_rules, d_rules)


@pytest.mark.parametrize("arch", ["stablelm-12b", "zamba2-2.7b"])
def test_build_serve_step_matches_jax(arch):
    j_params, toks, want, j_cache, j_rules = _jax_serve_steps(arch)
    _, t_cfg = _configs(arch)
    trainer = Trainer(TrainConfig(model=t_cfg, global_batch=B,
                                  seq_len=PROMPT + STEPS), device="cpu")
    sc = ShapeConfig(name="serve", seq_len=PROMPT + STEPS, global_batch=B,
                     kind="decode")
    prefill, p_rules = trainer.build_serve_step(sc, mode="prefill")
    decode, d_rules = trainer.build_serve_step(sc, mode="decode")
    # The serving rules are the JAX Trainer's (one device: no model axis,
    # the batch on 'data').
    assert (p_rules, d_rules) == j_rules
    assert prefill.model_axis is None
    params = convert.params_from_numpy(j_params, "cpu")
    cache = trainer.model.init_cache(B, PROMPT + STEPS, torch.float32,
                                     "cpu")
    lg, cache = prefill(params, {"tokens": torch.from_numpy(
        toks[:, :PROMPT])}, cache)
    got = [lg.numpy()]
    for t in range(PROMPT, PROMPT + STEPS):
        lg, cache = decode(params, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, cache)
        got.append(lg.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, F32_TOL, f"call {i}")
    _same_cache(cache, j_cache)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b",
                                  "musicgen-large"])
def test_cli_tokens_equal_a_greedy_loop(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--seed", "3", "--device", "cpu"]
    gen = serve.main(argv)
    printed = capsys.readouterr().out
    assert "prefill: 2x8" in printed and "decode : 3 steps" in printed
    cfg = get_smoke(arch)[0]
    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    assert tuple(gen.shape) == (2, 4) + k
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size
    # The same draw and a greedy loop over the model's own serve_step.
    dev = torch.device("cpu")
    model = build_model(cfg)
    params = serve.serve_params(model, 3, dev)
    assert all(p.dtype == torch.bfloat16 for _, p in flatten_tree(params))
    toks = serve.draw_prompts(cfg, 2, 8, 3, dev)
    cache = model.init_cache(2, 12, device=dev)
    kw = dict(compute_dtype=getattr(torch, cfg.compute_dtype))
    lg, cache = model.serve_step(params, {"tokens": toks}, cache,
                                 mode="prefill", **kw)
    want = [serve.greedy(lg)]
    for _ in range(3):
        lg, cache = model.serve_step(params, {"tokens": want[-1]}, cache,
                                     mode="decode", **kw)
        want.append(serve.greedy(lg))
    assert torch.equal(gen, torch.cat(want, dim=1))


def test_serve_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "smollm-135m", "--reduced"])


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32) \
        .astype(ml_dtypes.bfloat16)


def _round_trip_cases():
    rng = np.random.default_rng(6)
    kv = j_attention.KVCache(k=_bf16(rng, (2, 2, 5, 2, 4)),
                             v=rng.standard_normal((2, 2, 5, 2, 4))
                             .astype(np.float32),
                             index=np.array([3, 7], np.int32))
    m1 = j_mamba.MambaState(conv=_bf16(rng, (3, 2, 3, 8)),
                            ssm=rng.standard_normal((3, 2, 8, 4))
                            .astype(np.float32))
    m2 = j_mamba2.Mamba2State(conv=_bf16(rng, (2, 3, 2, 3, 12)),
                              ssm=rng.standard_normal((2, 3, 2, 2, 4, 4))
                              .astype(np.float32))
    from repro.models.hybrid_lm import HybridCache as JHybridCache
    return {"KVCache": kv, "MambaState": m1, "Mamba2State": m2,
            "HybridCache": JHybridCache(mamba=m2, attn=kv)}


@pytest.mark.parametrize("kind", ["KVCache", "MambaState", "Mamba2State",
                                  "HybridCache"])
def test_cache_round_trip_keeps_the_bits(kind):
    x = _round_trip_cases()[kind]
    t = convert.cache_from_numpy(x, "cpu")
    assert type(t).__module__.startswith("repro_torch")
    y = convert.cache_to_numpy(t)
    assert type(y) is type(t) and type(y).__name__ == kind
    for a, b in zip(jax.tree_util.tree_leaves(tuple(x)),
                    jax.tree_util.tree_leaves(tuple(y))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

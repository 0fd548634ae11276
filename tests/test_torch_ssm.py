"""The ssm and hybrid families of the port (falcon-mamba-7b's Mamba-1 LM,
zamba2-2.7b's Mamba-2 backbone with its shared attention block) against
the JAX package's, on the CPU. Weights carry across with ``convert``;
inputs come from seeded numpy.

* Every field of each ``CONFIG`` and ``SMOKE`` (``SSMConfig`` too) and
  ``shapes_for`` (with ``long_500k``) equal JAX's; the initialisers that
  draw nothing: ``dt_bias`` -4.6, ``D`` and ``norm_scale`` 1 bit for bit,
  ``A_log`` (Mamba-1: log 1..d_state a channel; Mamba-2: log of 1..16
  evenly spaced a head) within 2 f32 ulps: the port takes the logarithm
  (and the spacing) in f64 and rounds once, and XLA's CPU ``log`` and
  its rewritten ``linspace`` round otherwise at a few entries.
* ``mamba.apply_train`` and ``mamba2.apply_train`` at ``scan_chunk=8`` on
  32 positions (JAX's (state, conv window) carry crosses three chunk
  edges): the output and the gradients with respect to every parameter
  and to x. f32: within 1e-5 x the tensor's largest |value|. bf16: within
  2^-5 x the largest |value| (4 bf16 ulps at the top of the range: the
  two frameworks round the conv's taps, silu and the bf16 sums at
  different places), and no further from the f32 result than twice the
  JAX bf16 result's own distance from it.
* ``MambaLM`` and ``HybridLM``: the loss (rtol 1e-5) and every leaf's
  gradient (1e-5 x the leaf's largest |value|) in f32 on 256 positions
  (two 128-position chunks), with remat on and off; the hybrid's shared
  attention blockwise (64-position blocks) in the run without remat.
* The full configurations, without allocating: the leaf tables and the
  pool's buckets equal JAX's ``GradientPool``'s.
* The CLI trains both smoke configurations, and refuses to start without
  a card unless the CPU is asked for.

The Trainer's loss streams against JAX's are in
``test_torch_ssm_trainer.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.configs import shapes as j_shapes
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.models.layers import mamba as j_mamba
from repro.models.layers import mamba2 as j_mamba2
from repro.parallel.sharding import abstract_params, count_params, init_params
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke, shapes
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pool import (GradientPool, flatten_tree, tree_def,
                                   unflatten_tree)
from repro_torch.models import HybridLM, MambaLM, build_model
from repro_torch.models.layers import mamba, mamba2

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
LAYERS = {"mamba": (j_mamba, mamba, "falcon-mamba-7b"),
          "mamba2": (j_mamba2, mamba2, "zamba2-2.7b")}
# The layers' inputs: 32 positions in chunks of 8; the LMs': 256 positions
# (two of the default 128-position chunks).
B, L, CHUNK, LM_SEQ = 2, 32, 8, 256
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5
# tests/test_smoke_archs.py's parameter ranges for the full configs.
PARAM_RANGE = {"falcon-mamba-7b": (5e9, 9e9), "zamba2-2.7b": (1.8e9, 3.5e9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _close(got, want, tol, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (name, err, top)


@pytest.mark.parametrize("arch", ARCHS)
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
        t_ssm, j_ssm = got.pop("ssm"), want.pop("ssm")
        assert got == want, arch
        assert _fields(t_ssm) == _fields(j_ssm)
        assert t_cfg.supports_long_context and j_cfg.supports_long_context
    got = [c.name for c in shapes.shapes_for(get_arch(arch)[0])]
    assert got == [c.name for c in j_shapes.shapes_for(j_get_arch(arch)[0])]
    assert got[-1] == "long_500k" and len(got) == 4
    assert list(ARCH_IDS[-2:]) == list(ARCHS)
    model = build_model(get_arch(arch)[0])
    assert isinstance(model, MambaLM if arch == ARCHS[0] else HybridLM)


def test_deterministic_initialisers_match_jax():
    """Full-size widths: Mamba-1's (8192, 16) A_log, Mamba-2's 80 heads."""
    gen = torch.Generator()
    for name, (j_mod, t_mod, arch) in LAYERS.items():
        j_spec = j_mod.spec(j_get_arch(arch)[0])
        t_spec = t_mod.spec(get_arch(arch)[0])
        for leaf in ("dt_bias", "D", "norm_scale", "A_log"):
            if leaf not in j_spec:
                assert leaf not in t_spec
                continue
            s = j_spec[leaf]
            want = np.asarray(s.init(jax.random.PRNGKey(0), s.shape,
                                     jnp.float32))
            got = t_spec[leaf].init(gen, t_spec[leaf].shape).numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            if leaf != "A_log":
                np.testing.assert_array_equal(got, want, err_msg=leaf)
                continue
            ulps = np.abs(got.view(np.int32).astype(np.int64)
                          - want.view(np.int32))
            assert ulps.max() <= 2, (name, ulps.max())
            exact = np.log(np.linspace(1.0, 16.0, s.shape[0])) \
                if name == "mamba2" else np.log(np.arange(1.0, 17.0))
            np.testing.assert_array_equal(
                got if name == "mamba2" else got[0], exact.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _layer_run(name, dtype):
    """(output, {leaf: grad}, grad x) of JAX's or the port's apply_train on
    the same weights, input and cotangent, as f32 numpy."""
    j_mod, t_mod, arch = LAYERS[name]
    j_cfg, t_cfg = j_get_smoke(arch)[0], get_smoke(arch)[0]
    params = jax.tree_util.tree_map(np.asarray, init_params(
        j_mod.spec(j_cfg), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, j_cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, L, j_cfg.d_model)).astype(np.float32)
    if dtype.startswith("jax"):
        jd = getattr(jnp, dtype[4:])

        @jax.jit
        def run(p, xx, cc):
            out, vjp = jax.vjp(lambda p, xx: j_mod.apply_train(
                p, xx, j_cfg, scan_chunk=CHUNK), p, xx)
            return (out,) + vjp(cc)
        out, gp, gx = run({k: jnp.asarray(v, jd) for k, v in params.items()},
                          jnp.asarray(x, jd), jnp.asarray(ct, jd))
        f32 = functools.partial(np.asarray, dtype=np.float32)
        return f32(out), {k: f32(v) for k, v in gp.items()}, f32(gx)
    td = getattr(torch, dtype)
    leaves = {k: v.to(td).requires_grad_(True) for k, v in
              convert.params_from_numpy(params, "cpu").items()}
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    out = t_mod.apply_train(leaves, xt, t_cfg, scan_chunk=CHUNK)
    assert out.dtype == td and out.shape == xt.shape
    grads = torch.autograd.grad(out, list(leaves.values()) + [xt],
                                torch.from_numpy(ct).to(td))

    def f32(t):
        return t.detach().float().numpy()
    return f32(out), {k: f32(g) for k, g in zip(leaves, grads)}, \
        f32(grads[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name, dtype):
    def named(run):
        out, gp, gx = run
        return {"out": out, "x": gx, **gp}

    got = named(_layer_run(name, dtype))
    want = named(_layer_run(name, "jax_" + dtype))
    assert set(got) == set(want)
    if dtype == "float32":
        for k in want:
            _close(got[k], want[k], F32_TOL, k)
        return
    ref = named(_layer_run(name, "jax_float32"))
    for k in want:
        _close(got[k], want[k], BF16_TOL, k)
        port_err = np.abs(got[k] - ref[k]).max()
        jax_err = np.abs(want[k] - ref[k]).max()
        assert port_err <= 2 * jax_err, (k, port_err, jax_err)


@pytest.mark.parametrize("arch,remat,chunk", [
    ("falcon-mamba-7b", "layer", 0), ("falcon-mamba-7b", "none", 0),
    ("zamba2-2.7b", "layer", 0), ("zamba2-2.7b", "none", 64)])
def test_lm_loss_and_grads_match_jax(arch, remat, chunk):
    j_cfg, t_cfg = j_get_smoke(arch)[0], get_smoke(arch)[0]
    j_model, t_model = j_build_model(j_cfg), build_model(t_cfg)
    j_params = init_params(j_model.param_specs(), jax.random.PRNGKey(3))
    t_params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_params), device="cpu")
    toks = np.random.default_rng(0).integers(0, t_cfg.vocab_size,
                                             (1, LM_SEQ + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def j_loss(p):
        return j_model.loss_fn(
            p, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
            remat=remat, scan_layers=remat == "layer", attn_chunk=chunk,
            compute_dtype=jnp.float32)
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(j_params)
    flat = flatten_tree(t_params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
    t_total, t_metrics = t_model.loss_fn(
        unflatten_tree(tree_def(t_params), leaves),
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat,
        attn_chunk=chunk, compute_dtype=torch.float32)
    grads = torch.autograd.grad(t_total, leaves)
    np.testing.assert_allclose(float(t_total.detach()), float(j_total),
                               rtol=1e-5)
    assert float(t_metrics["aux_loss"]) == float(j_metrics["aux_loss"]) == 0
    j_flat = {"/".join(str(k.key) for k in path): np.asarray(g)
              for path, g in jax.tree_util.tree_flatten_with_path(
                  j_grads)[0]}
    assert set(j_flat) == {"/".join(p) for p, _ in flat}
    for (path, _), g in zip(flat, grads):
        _close(g.numpy(), j_flat["/".join(path)], F32_TOL, "/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tables_match_jax(arch):
    """The leaf table (name, shape, offset), the pool's size and its
    buckets at 4 Mi elements, unpadded and padded to 32,768-element
    chunks, equal to JAX's; nothing is allocated."""
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
    if arch == "zamba2-2.7b":  # the shared block is in the pool once
        assert t_pool.unpadded_size == 2_422_670_240
        assert sum(s.name.startswith("shared_attn/") for s in t_pool.specs) \
            == len(flatten_tree(t_model.param_shapes()["shared_attn"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_smoke_configs(arch):
    from repro_torch.launch import train as t_train

    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq-len", "32", "--chunk-elems", "512", "--csc-warmup", "1",
            "--window-steps", "1", "--use-kernels"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_train.train(t_train.parse_args(argv))
    trainer, losses, _, run = t_train.train(
        t_train.parse_args(argv + ["--device", "cpu"]))
    assert run["restarts"] == 0 and run["preempted"] is None
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert trainer.cfg.model.name == get_smoke(arch)[0].name

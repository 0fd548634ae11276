"""The port's whole-pool update (``optim.update_pool``, the plain version of
the ``fused_update`` kernel) against the JAX package's
``optim.sgd.update_pool``, with its Pallas kernel (interpret mode) and
without, with and without a per-element scale, at three mask fractions.

Tolerance: against the JAX function without its kernel, bit for bit
(both round every step on its own). Against the Pallas kernel in
interpret mode, rtol 1e-6 and atol 1e-7: there XLA contracts a multiply
and an add into one fused multiply-add, which moves a result by one ulp
(at most 1.2e-7 absolute on these inputs, 3.7e-9 on the momentum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.optim import sgd as j_sgd
from repro_torch import optim
from repro_torch.configs import base as t_base
from repro_torch.kernels import fused_update as t_fu
from repro_torch.kernels import ops

N = 10_007  # ragged: no power-of-two block divides it
KW = dict(momentum=0.9, weight_decay=1e-4, learning_rate=0.05)


def _inputs(frac, seed=0):
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(N).astype(np.float32)
    grads = (rng.standard_normal(N) * 1e-2).astype(np.float32)
    mom = (rng.standard_normal(N) * 1e-2).astype(np.float32)
    mask = rng.random(N) < frac
    scale = rng.uniform(0.1, 2.0, N).astype(np.float32)
    return master, grads, mom, mask, scale


@pytest.mark.parametrize("frac", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("jax_kernel", [False, True])
def test_update_pool_matches_jax(frac, with_scale, jax_kernel):
    master, grads, mom, mask, scale = _inputs(frac)
    lr = np.float32(0.05)
    j_cfg = j_base.OptimizerConfig(**KW)
    j_master, j_state = j_sgd.update_pool(
        jnp.asarray(master), jnp.asarray(grads),
        j_sgd.SGDState(momentum=jnp.asarray(mom)), jnp.asarray(mask), j_cfg,
        jnp.asarray(lr), scale=jnp.asarray(scale) if with_scale else None,
        use_kernels=jax_kernel)
    t_cfg = t_base.OptimizerConfig(**KW)
    t_args = [torch.from_numpy(a) for a in (master, grads, mom, mask)]
    t_scale = torch.from_numpy(scale) if with_scale else None
    for use_kernels in (False, True):
        ops.reset_counts()
        t_master, t_state = optim.update_pool(
            "momentum_sgd", t_args[0], t_args[1],
            optim.SGDState(momentum=t_args[2]), t_args[3], t_cfg,
            torch.tensor(lr), scale=t_scale, use_kernels=use_kernels)
        assert ops.dispatch_counts == (
            {"fused_update.plain": 1} if use_kernels else {})
        for got, want in ((t_master, j_master),
                          (t_state.momentum, j_state.momentum)):
            if jax_kernel:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The inputs are left as they were (the update returns new tensors).
    assert np.array_equal(t_args[0].numpy(), master)
    assert np.array_equal(t_args[2].numpy(), mom)
    # Unselected elements keep master and momentum bit for bit.
    keep = ~mask
    assert np.array_equal(t_master.numpy()[keep], master[keep])
    assert np.array_equal(t_state.momentum.numpy()[keep], mom[keep])


def test_plain_version_is_the_update_math():
    master, grads, mom, mask, scale = _inputs(0.5, seed=1)
    args = [torch.from_numpy(a) for a in (master, grads, mom, mask)]
    kw = dict(lr=torch.tensor(0.05), momentum=0.9, weight_decay=1e-4)
    for s in (None, torch.from_numpy(scale)):
        a = t_fu.plain(*args, scale=s, **kw)
        b = ops.fused_update(*args, scale=s, **kw)
        g = args[1] + 1e-4 * args[0]
        if s is not None:
            g = g * s
        u = 0.9 * args[2] + kw["lr"] * g
        want = (torch.where(args[3], args[0] - u, args[0]),
                torch.where(args[3], u, args[2]))
        for x, y, z in zip(a, b, want):
            assert torch.equal(x, y) and torch.equal(x, z)
    with pytest.raises(ValueError, match="runs on CUDA"):
        t_fu.launch(*args, **kw)


def test_update_pool_lars_and_adamw():
    """'lars' is momentum SGD under the caller's scale; 'adamw' is the JAX
    package's ``adamw.update_pool`` (see ``test_torch_lars_adamw.py`` for
    its masked steps); an unknown name raises."""
    from repro.optim import adamw as j_adamw

    master, grads, mom, mask, scale = _inputs(0.5, seed=2)
    args = [torch.from_numpy(a) for a in (master, grads)]
    st = optim.SGDState(momentum=torch.from_numpy(mom))
    m = torch.from_numpy(mask)
    cfg = t_base.OptimizerConfig(**KW)
    a = optim.update_pool("lars", *args, st, m, cfg, 0.05,
                          scale=torch.from_numpy(scale))
    b = optim.update_pool("momentum_sgd", *args, st, m, cfg, 0.05,
                          scale=torch.from_numpy(scale))
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].momentum, b[1].momentum)
    t_master, t_state = optim.update_pool(
        "adamw", *args, optim.init_state("adamw", N, "cpu"), m, cfg,
        torch.tensor(np.float32(0.05)))
    j_master, j_state = j_adamw.update_pool(
        jnp.asarray(master), jnp.asarray(grads), j_adamw.init(N),
        jnp.asarray(mask), j_base.OptimizerConfig(**KW),
        jnp.asarray(np.float32(0.05)))
    np.testing.assert_array_equal(t_state.counts.numpy(),
                                  np.asarray(j_state.counts))
    # atol: a step's last ulp where master - step cancels (PyTorch's CPU
    # sqrt is not correctly rounded at every input).
    for got, want, atol in ((t_master, j_master, 1e-8),
                            (t_state.mu, j_state.mu, 0.0),
                            (t_state.nu, j_state.nu, 0.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=atol)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.update_pool("sgdd", *args, st, m, cfg, 0.05)

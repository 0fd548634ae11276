"""The port's pool kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp references, on the
same numpy-seeded inputs. The CUDA kernels themselves run only on the
card: ``test_torch_cuda.py`` holds them against the plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pool_pack as j_pack
from repro.kernels import pool_unpack as j_unpack
from repro.kernels import ref as j_ref
from repro.kernels import tiling as j_tiling
from repro_torch.kernels import ops
from repro_torch.kernels import pool_pack as t_pack
from repro_torch.kernels import pool_unpack as t_unpack
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import tiling as t_tiling

SIZES = (37, 128, 5, 300, 1, 77)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _table(sizes):
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return tuple(offsets), off


def _leaves(seed, sizes, dtypes):
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    jl = [jnp.asarray(v, DTYPES[d][0]) for v, d in zip(vals, dtypes)]
    tl = [torch.from_numpy(v).to(DTYPES[d][1]) for v, d in zip(vals, dtypes)]
    return jl, tl


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
@pytest.mark.parametrize("chunk,tile", [(0, 0), (0, 32), (64, 0), (64, 64),
                                        (32, 96)])
@pytest.mark.parametrize("mixed", [False, True])
def test_pool_pack_matches_jax(wire, chunk, tile, mixed):
    offsets, covered = _table(SIZES)
    pool_size = covered if not chunk else -(-covered // chunk) * chunk + chunk
    dts = ["bfloat16" if (mixed and i % 2) else "float32"
           for i in range(len(SIZES))]
    jl, tl = _leaves(0, SIZES, dts)
    want_k, norms_k = j_pack.pool_pack(
        tuple(jl), offsets, SIZES, pool_size, chunk, wire, tile_elems=tile,
        interpret=True)
    want_r, norms_r, _ = j_ref.pool_pack(jl, offsets, pool_size, chunk, wire)
    got, norms = t_pack.plain(tl, offsets, SIZES, pool_size, chunk,
                              DTYPES[wire][1])
    assert got.dtype == DTYPES[wire][1]
    # Data movement and a round-to-nearest-even cast: bit for bit.
    np.testing.assert_array_equal(_np(got), _np(want_k))
    np.testing.assert_array_equal(_np(got), _np(want_r))
    if chunk:
        # Same values summed in another order: f32 rounding only.
        np.testing.assert_allclose(_np(norms), _np(norms_k), rtol=1e-6)
        np.testing.assert_allclose(_np(norms), _np(norms_r), rtol=1e-6)
    else:
        assert norms is None and norms_k is None


def test_pool_pack_empty_leaf_matches_jax_ref():
    """A zero-size leaf (the Pallas interpreter rejects one, the jnp
    reference does not)."""
    sizes = (37, 0, 5)
    offsets, covered = _table(sizes)
    jl, tl = _leaves(8, sizes, ["float32"] * 3)
    want, norms_w, _ = j_ref.pool_pack(jl, offsets, 64, 16, "bfloat16")
    got, norms = t_pack.plain(tl, offsets, sizes, 64, 16, torch.bfloat16)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(_np(norms), _np(norms_w), rtol=1e-6)


def test_pool_pack_staging_matches_jax():
    offsets, pool_size = _table(SIZES)
    jl, tl = _leaves(1, SIZES, ["float32"] * len(SIZES))
    stale = np.full((pool_size,), 7.0, np.float32)
    want, _ = j_pack.pool_pack(tuple(jl), offsets, SIZES, pool_size, 0,
                               "bfloat16", staging=jnp.asarray(
                                   stale, jnp.bfloat16), interpret=True)
    buf = torch.from_numpy(stale).to(torch.bfloat16)
    got, _ = t_pack.plain(tl, offsets, SIZES, pool_size, 0, torch.bfloat16,
                          out=buf)
    assert got.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(_np(buf), _np(want))
    # The dispatch layer's staging contract on the CPU: the wire-dtype
    # buffer is written in place and comes back as the pool.
    buf.fill_(7.0)
    pool, _ = ops.pool_pack(tl, offsets, SIZES, pool_size, 0,
                            torch.bfloat16, out=buf)
    np.testing.assert_array_equal(_np(pool), _np(want))
    assert pool is buf


def test_pool_pack_staging_zeroes_uncovered_elements():
    """Stale staging values outside every leaf (a gap, an empty leaf, the
    padding tail) come back as zeros, as in a fresh pool."""
    sizes = (37, 0, 5)
    offsets = (0, 40, 40)
    jl, tl = _leaves(10, sizes, ["float32"] * 3)
    want, _, _ = j_ref.pool_pack(jl, offsets, 64, 0, "bfloat16")
    buf = torch.full((64,), 7.0, dtype=torch.bfloat16)
    got, _ = t_pack.plain(tl, offsets, sizes, 64, 0, torch.bfloat16, out=buf)
    assert got is buf
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("offsets,sizes,error", [
    ((0, 40), (37, 5), "previous one ends"),   # gap between leaves
    ((3, 40), (37, 5), "previous one ends"),   # first leaf not at 0
    ((0, 30), (37, 5), "previous one ends"),   # overlap
    ((0, 37), (37, 50), "past the pool"),      # runs off the end
])
def test_kernel_segment_table_must_be_gap_free(offsets, sizes, error):
    """The CUDA kernels assume each element below the last leaf's end
    belongs to the first segment ending past it; the wrappers' check
    refuses any other table before a launch."""
    leaves = [torch.zeros(s) for s in sizes]
    with pytest.raises(ValueError, match=error):
        t_pack.check_segments(leaves, offsets, sizes, 64, torch.device("cpu"))
    good = [torch.zeros(37), torch.zeros(5)]
    t_pack.check_segments(good, (0, 37), (37, 5), 42, torch.device("cpu"))


def _update_inputs(seed, n, with_mask):
    rng = np.random.default_rng(seed)
    master, grads, mom = (rng.standard_normal(n).astype(np.float32)
                          for _ in range(3))
    mask = rng.random(n) < 0.7 if with_mask else np.ones(n, bool)
    return master, grads, mom, mask


@pytest.mark.parametrize("extra", ["none", "scale", "ratios", "ratios_pad"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pool_unpack_update_matches_jax(extra, with_mask):
    sizes = (37, 128, 5, 300, 77)
    offsets, covered = _table(sizes)
    n = covered + 11  # padding tail
    master, grads, mom, mask = _update_inputs(2, n, with_mask)
    rng = np.random.default_rng(3)
    scale = ratios = None
    if extra == "scale":
        scale = rng.random(n).astype(np.float32)
    elif extra.startswith("ratios"):
        k = len(sizes) + (1 if extra == "ratios_pad" else 0)
        ratios = rng.random(k).astype(np.float32)
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(a)

    args_j = (jx(master), jx(grads), jx(mom), jx(mask), offsets, sizes)
    want_leaves_r, want_mom_r = j_ref.pool_unpack_update(
        *args_j, scale=jx(scale), ratios=jx(ratios), **kw)
    leaves, new_mom = t_unpack.plain(
        tx(master), tx(grads), tx(mom), tx(mask), offsets, sizes,
        scale=tx(scale), ratios=tx(ratios), **kw)
    # XLA-CPU may contract a multiply-add into an FMA: last-ulp rtol.
    np.testing.assert_allclose(_np(new_mom), _np(want_mom_r), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(leaves, want_leaves_r):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    if extra != "ratios_pad":  # the Pallas kernel pads ratios with 1.0
        want_leaves_k, want_mom_k = j_unpack.pool_unpack_update(
            *args_j, scale=jx(scale), ratios=jx(ratios), tile_elems=64,
            interpret=True, **kw)
        np.testing.assert_allclose(_np(new_mom), _np(want_mom_k), rtol=1e-6,
                                   atol=1e-7)
        for a, b in zip(leaves, want_leaves_k):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_pool_unpack_update_in_place_outputs():
    sizes = (37, 128, 5)
    offsets, n = _table(sizes)
    master, grads, mom, mask = (torch.from_numpy(a) for a in
                                _update_inputs(4, n, True))
    want_leaves, want_mom = t_ref.pool_unpack_update(
        master, grads, mom, mask, offsets, sizes, lr=0.1, momentum=0.9,
        weight_decay=0.0)
    dst = [torch.zeros(s) for s in sizes]
    mom_buf = mom.clone()
    leaves, new_mom = ops.pool_unpack_update(
        master, grads, mom_buf, mask, offsets, sizes, lr=0.1, momentum=0.9,
        weight_decay=0.0, out_leaves=dst, out_momentum=mom_buf)
    assert new_mom is mom_buf and all(a is b for a, b in zip(leaves, dst))
    assert torch.equal(mom_buf, want_mom)
    for a, b in zip(dst, want_leaves):
        assert torch.equal(a, b)


def test_dispatch_counts_plain_on_cpu():
    ops.reset_counts()
    offsets, n = _table(SIZES)
    _, tl = _leaves(5, SIZES, ["float32"] * len(SIZES))
    ops.pool_pack(tl, offsets, SIZES, n, 0, torch.bfloat16)
    m = torch.zeros(n)
    ops.pool_unpack_update(m, m, m.clone(), torch.ones(n, dtype=torch.bool),
                           offsets, SIZES, lr=0.1, momentum=0.9,
                           weight_decay=0.0)
    assert ops.dispatch_counts == {"pool_pack.plain": 1,
                                   "pool_unpack_update.plain": 1}


@pytest.mark.parametrize("sizes,tile", [(SIZES, 64), ((5,), 2),
                                        ((100, 0, 28), 32)])
def test_tile_schedule_matches_jax(sizes, tile):
    offsets, covered = _table(sizes)
    for pool_size in (covered, covered + 40):
        want = j_tiling.tile_schedule(offsets, sizes, pool_size, tile)
        got = t_tiling.tile_schedule(offsets, sizes, pool_size, tile)
        assert got.num_tiles == want.num_tiles
        assert [tuple(vars(c).values()) for c in got.copies] == \
            [tuple(vars(c).values()) for c in want.copies]
        assert [tuple(vars(c).values()) for c in got.fills] == \
            [tuple(vars(c).values()) for c in want.fills]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sgd_update_unpack_matches_jax(use_kernels):
    """The whole-pool optimizer entry point against the JAX optimizer's."""
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.core.pool import GradientPool as JPool
    from repro.optim import sgd as j_sgd
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.pool import GradientPool
    from repro_torch.optim import sgd

    shapes = {"a": (3, 7), "b": {"c": (11,), "d": (2, 2, 5)}}
    tp = GradientPool(shapes, pad_to=16)
    jp = JPool({"a": jnp.zeros((3, 7)),
                "b": {"c": jnp.zeros((11,)), "d": jnp.zeros((2, 2, 5))}},
               pad_to=16)
    master, grads, mom, mask = _update_inputs(9, tp.size, True)
    kw = dict(momentum=0.9, weight_decay=1e-3)
    j_tree, j_state = j_sgd.update_unpack(
        jp, jnp.asarray(master), jnp.asarray(grads),
        j_sgd.SGDState(jnp.asarray(mom)), jnp.asarray(mask), JOpt(**kw),
        jnp.float32(0.05))
    t_tree, t_state = sgd.update_unpack(
        tp, torch.from_numpy(master), torch.from_numpy(grads),
        sgd.SGDState(torch.from_numpy(mom.copy())), torch.from_numpy(mask),
        OptimizerConfig(**kw), torch.tensor(0.05), use_kernels=use_kernels)
    np.testing.assert_allclose(_np(t_state.momentum),
                               _np(j_state.momentum), rtol=1e-6, atol=1e-7)
    for a, b in zip(tp.flat_leaves(t_tree), jp.flat_leaves(j_tree)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)

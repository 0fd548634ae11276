"""The port's gradient-pool segment table against the JAX package's, on
the smoke tree and on the full smollm-135m shapes (built from shapes, no
allocation): names, offsets, sizes, padding, bucket boundaries and
bucket views must be identical."""
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.parallel.sharding import abstract_params
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.pool import GradientPool
from repro_torch.models import build_model


def _pools(full: bool, pad_to: int):
    j_cfg = (j_get_arch if full else j_get_smoke)("smollm-135m")[0]
    t_cfg = (get_arch if full else get_smoke)("smollm-135m")[0]
    jp = JPool(abstract_params(j_build_model(j_cfg).param_specs()),
               pad_to=pad_to)
    tp = GradientPool(build_model(t_cfg).param_shapes(), pad_to=pad_to)
    return jp, tp


def _rows(specs):
    return [(s.name, tuple(s.shape), s.size, s.offset) for s in specs]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("pad_to", [1, 32768])
def test_segment_table_matches_jax(full, pad_to):
    jp, tp = _pools(full, pad_to)
    assert _rows(tp.specs) == _rows(jp.specs)
    assert (tp.offsets, tp.sizes) == (jp.offsets, jp.sizes)
    assert (tp.size, tp.unpadded_size, tp.padding) == \
        (jp.size, jp.unpadded_size, jp.padding)
    if full and pad_to == 1:
        # The layout the main path's kernels run on.
        assert tp.size == 134_515_008 and tp.num_tensors == 11
        assert tp.specs[0].name == "layers/mlp_norm/scale"
        assert tp.specs[-1].name == "embed/tokens"
        assert len(tp.bucket_boundaries(4_194_304)) == 6


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("theta", [0, 1, 8192, 4_194_304, 16 * 1024 * 1024])
def test_buckets_and_views_match_jax(full, theta):
    jp, tp = _pools(full, 1)
    bounds = tp.bucket_boundaries(theta)
    assert bounds == jp.bucket_boundaries(theta)
    for s, e in bounds:
        jv, tv = jp.bucket_view(s, e), tp.bucket_view(s, e)
        assert (tv.start, tv.end, tv.leaf_lo, tv.leaf_hi, tv.offsets,
                tv.sizes, tv.padding) == \
            (jv.start, jv.end, jv.leaf_lo, jv.leaf_hi, jv.offsets,
             jv.sizes, jv.padding)
        assert tv.size == jv.size and tv.num_tensors == jv.num_tensors


def test_pack_unravel_roundtrip_matches_jax():
    import jax.numpy as jnp

    jp, tp = _pools(False, 64)
    rng = np.random.default_rng(0)
    shapes = [s.shape for s in tp.specs]
    vals = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    t_tree = tp.unflatten([torch.from_numpy(v).reshape(-1) for v in vals])
    j_tree = jp.unflatten([jnp.asarray(v).reshape(-1) for v in vals])
    got, _ = tp.pack(t_tree, torch.bfloat16)
    want, _ = jp.pack(j_tree, jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    back = tp.unravel(tp.pack(t_tree)[0])
    for a, b in zip(tp.flat_leaves(back), tp.flat_leaves(t_tree)):
        assert torch.equal(a, b)
    staging = torch.zeros(tp.size)
    pool, _, st = tp.pack_into(staging, t_tree, torch.float32)
    assert st is staging and torch.equal(pool, tp.pack(t_tree)[0])

"""The launch plans of the two CSC kernels, on the CPU: the path each
wrapper picks for a row's bytes and addresses, that every (row, piece) of
the gather and every chunk of the census is covered exactly once at any
grid, the shared memory a CTA asks for, that the plans' constants are the
sources', and a numpy model of the census kernel's summation order (the
same bits at any grid, close to the JAX package's census). The kernels
themselves run only on the card (``test_torch_cuda.py``)."""
import os
import re
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_l1norm as j_cl
from repro.kernels import csc_compact as j_cc
from repro.kernels import ref as j_ref
from repro_torch.kernels import build
from repro_torch.kernels import chunk_l1norm as t_cl
from repro_torch.kernels import csc_compact as t_cc
from repro_torch.kernels import ref as t_ref

SMS = (132, 114)  # H100 SXM, H100 PCIe


def _source(name):
    with open(os.path.join(os.path.dirname(t_cl.__file__), "csrc",
                           name)) as f:
        return f.read()


def _constant(src, name):
    """A constexpr integer of the source: a literal or ``aLL << b``."""
    text = re.search(rf"\b{name} = ([^;,]+)[;,]", src).group(1)
    m = re.fullmatch(r"(\d+)(?:LL)?(?: << (\d+))?", text.strip())
    return int(m.group(1)) << int(m.group(2) or 0)


def _compact_plan(k, chunk, itemsize=4, align=16, sms=132, grid=None):
    return t_cc.plan(k, 4106, chunk * itemsize, itemsize, align, sms, grid)


# -- csc_compact -------------------------------------------------------------


@pytest.mark.parametrize("chunk", [33, 1024, 32768])
@pytest.mark.parametrize("k", ["1", "below grid", "far above grid"])
@pytest.mark.parametrize("sms", SMS)
def test_compact_schedule_covers_every_byte_once(chunk, k, sms):
    """Every output row is copied exactly once, byte for byte, whatever
    the number of rows against the grid."""
    k = {"1": 1, "below grid": 9, "far above grid": 3233}[k]
    row_bytes = chunk * 4
    p = _compact_plan(k, chunk, sms=sms)
    ranges = defaultdict(list)
    per_cta = defaultdict(int)
    for cta, row, lo, hi in t_cc.schedule(p, row_bytes):
        assert 0 <= cta < p["ctas"] and 0 <= row < k and lo < hi
        ranges[row].append((lo, hi))
        per_cta[cta] += 1
    assert sorted(ranges) == list(range(k))
    for row, rs in ranges.items():
        rs.sort()
        assert rs[0][0] == 0 and rs[-1][1] == row_bytes, row
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:])), row
    if p["path"] == "bulk":
        # Persistent: at most CTAS_PER_SM a SM, the items dealt round robin
        # (no CTA has two more than another), each a whole number of
        # 16-byte units no larger than a stage.
        assert p["grid"] == min(p["items"], sms * t_cc.CTAS_PER_SM)
        assert max(per_cta.values()) - min(per_cta.values()) <= 1
        assert len(per_cta) == p["grid"]
        for rs in ranges.values():
            assert all(lo % 16 == 0 and (hi - lo) % 16 == 0 and
                       hi - lo <= p["stage_bytes"] for lo, hi in rs)


@pytest.mark.parametrize("grid", [1, 7, 77])
def test_compact_schedule_at_a_given_grid(grid):
    """The grid the card test and chip_smoke.py pass: still each byte of
    each row once."""
    p = _compact_plan(616, 32768, grid=grid)
    pieces = -(-32768 * 4 // t_cc.STAGE_BYTES)
    assert p["grid"] == grid and p["items"] == 616 * pieces
    seen = defaultdict(int)
    for _, row, lo, _ in t_cc.schedule(p, 32768 * 4):
        seen[(row, lo)] += 1
    assert len(seen) == p["items"] and set(seen.values()) == {1}


def test_compact_paths():
    """Aligned f32 and bf16 rows take the bulk path; a view at an odd
    element offset, or a row whose bytes are not a multiple of 16, takes
    the widest copy unit its addresses allow."""
    pool = torch.zeros(64 * 1024 + 8)
    base = build.base_align(pool.data_ptr())
    assert base == 16  # the allocator aligns far more
    cases = {
        ("float32", 0, 1024): ("bulk", 16),
        ("bfloat16", 0, 1024): ("bulk", 16),
        ("bfloat16", 0, 32768): ("bulk", 16),
        ("float32", 1, 1024): ("element", 4),
        ("float32", 2, 1024): ("vector", 8),
        ("bfloat16", 1, 1024): ("element", 2),
        ("bfloat16", 2, 1024): ("vector", 4),
        ("float32", 0, 33): ("element", 4),
        ("float32", 0, 34): ("vector", 8),
    }
    for (dtype, offset, chunk), (path, unit) in cases.items():
        x = pool.to(getattr(torch, dtype))[offset:offset + 8 * chunk]
        p = t_cc.plan(8, 8, chunk * x.element_size(), x.element_size(),
                      build.base_align(x.data_ptr()), 132)
        assert (p["path"], p["unit_bytes"]) == (path, unit), (dtype, offset,
                                                              chunk)
    bf = _compact_plan(616, 32768, itemsize=2)
    stage = min(t_cc.STAGE_BYTES, 65536)
    assert (bf["stage_bytes"], bf["pieces"]) == (stage, -(-65536 // stage))
    small = _compact_plan(5, 256)  # a row smaller than a stage: one piece
    assert (small["stage_bytes"], small["pieces"]) == (1024, 1)


@pytest.mark.parametrize("chunk,itemsize", [(33, 4), (1024, 4), (32768, 4),
                                            (32768, 2), (12292, 4)])
def test_compact_shared_memory_fits(chunk, itemsize):
    p = _compact_plan(616, chunk, itemsize=itemsize)
    assert p["smem_bytes"] <= t_cc.SMEM_LIMIT
    assert p["stage_bytes"] <= t_cc.STAGE_BYTES
    if p["path"] == "bulk":
        # A store trails its load by stages - 2 >= 1 items.
        assert p["stages"] >= 3 and p["stage_bytes"] % 16 == 0
        assert t_cc.CTAS_PER_SM * p["smem_bytes"] <= t_cc.SMEM_LIMIT


def test_compact_plan_constants_match_the_source():
    src = _source("csc_compact.cu")
    assert _constant(src, "kThreads") == t_cc.THREADS
    assert _constant(src, "kUnitsPerThread") == t_cc.UNITS_PER_THREAD
    assert _constant(src, "kMaxSlices") == t_cc.MAX_SLICES
    assert _constant(src, "kPathBulk") == t_cc.PATH_CODES["bulk"]


def test_compact_plan_refuses_a_grid_past_its_items():
    items = _compact_plan(2, 32768)["items"]
    with pytest.raises(ValueError, match="grid"):
        _compact_plan(2, 32768, grid=items + 1)
    with pytest.raises(ValueError, match="grid"):
        _compact_plan(2, 32768, grid=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [33, 1024, 12292])
def test_compact_schedule_gathers_what_jax_gathers(dtype, chunk):
    """Carrying out the plan's copies on the pool's bytes gives the JAX
    package's gather (its Pallas kernel in interpret mode), bit for
    bit."""
    num_chunks, k = 12, 5
    x = np.random.default_rng(5).standard_normal(
        num_chunks * chunk).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx = jnp.asarray(x, jdt)
    idx = np.sort(np.random.default_rng(6).choice(num_chunks, k,
                                                  replace=False))
    want = np.asarray(j_cc.csc_compact(jx, jnp.asarray(idx, jnp.int32),
                                       chunk, interpret=True))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    row_bytes = chunk * tx.element_size()
    src = tx.view(torch.uint8).numpy().reshape(num_chunks, row_bytes)
    out = np.full((k, row_bytes), 0xAB, np.uint8)
    for grid in (None, 1, 3):
        p = t_cc.plan(k, num_chunks, row_bytes, tx.element_size(), 16, 132,
                      grid)
        out[:] = 0xAB
        for _, row, lo, hi in t_cc.schedule(p, row_bytes):
            out[row, lo:hi] = src[idx[row], lo:hi]
        got = torch.from_numpy(out.reshape(-1).copy()).view(
            getattr(torch, dtype)).float().numpy()
        np.testing.assert_array_equal(
            got, np.asarray(want.astype(np.float32)).reshape(-1))
        np.testing.assert_array_equal(
            got, t_ref.csc_compact(tx, torch.from_numpy(idx), chunk)
            .float().numpy())


# -- chunk_l1norm ------------------------------------------------------------


def test_census_paths():
    """f32 rows of a multiple of 16 bytes on an aligned base take the bulk
    path; aligned bf16 rows the 16-byte block path; a view at an odd
    element offset, or a row not a multiple of 16 bytes, the element
    path."""
    pool = torch.zeros(64 * 1024 + 8)
    cases = {
        ("float32", 0, 1024): "bulk",
        ("float32", 0, 32768): "bulk",
        ("bfloat16", 0, 1024): "vector",
        ("bfloat16", 0, 32768): "vector",
        ("float32", 1, 1024): "element",
        ("bfloat16", 1, 1024): "element",
        ("float32", 2, 1024): "element",
        ("float32", 0, 33): "element",
    }
    for (dtype, offset, chunk), path in cases.items():
        x = pool.to(getattr(torch, dtype))[offset:offset + 8 * chunk]
        p = t_cl.plan(8, chunk, x.element_size(),
                      build.base_align(x.data_ptr()), 132)
        assert p["path"] == path, (dtype, offset, chunk)


@pytest.mark.parametrize("chunk", [33, 1024, 32768, 12292])
@pytest.mark.parametrize("num_chunks", [1, 9, 4106])
@pytest.mark.parametrize("sms", SMS)
def test_census_covers_every_chunk_once(chunk, num_chunks, sms):
    p = t_cl.plan(num_chunks, chunk, 4, 16, sms)
    cap = sms * t_cl.CTAS_PER_SM if p["path"] == "bulk" else t_cl.MAX_BLOCKS
    assert p["grid"] == min(num_chunks, cap)
    seen = [c for cta in range(p["grid"])
            for c in range(cta, num_chunks, p["grid"])]  # CTA b's chunks
    assert sorted(seen) == list(range(num_chunks))
    if p["path"] == "bulk":
        assert p["pieces"] == -(-chunk * 4 // t_cl.STAGE_BYTES)
        assert p["smem_bytes"] <= t_cl.SMEM_LIMIT
        assert t_cl.CTAS_PER_SM * p["smem_bytes"] <= t_cl.SMEM_LIMIT


def test_census_plan_constants_match_the_source():
    """The numpy order model and the plan read the source's constants;
    a piece boundary never moves a vector to another thread."""
    src = _source("chunk_l1norm.cu")
    assert _constant(src, "kStageBytes") == t_cl.STAGE_BYTES
    assert 32 * _constant(src, "kConsumerWarps") == t_cl.CONSUMERS
    assert _constant(src, "kMaxBlocks") == t_cl.MAX_BLOCKS
    assert t_cl.STAGE_BYTES % (16 * t_cl.CONSUMERS) == 0
    for path, code in t_cl.PATH_CODES.items():
        assert f"kPath{path.capitalize()} = {code}" in src


def _census_at_grid(pool, chunk, grid):
    """The norms the persistent grid writes, CTA by CTA, each chunk by
    the model's order."""
    num_chunks = pool.size // chunk
    p = t_cl.plan(num_chunks, chunk, 4, 16, 132, grid)
    norms = np.full(num_chunks, np.nan, np.float32)
    rows = pool.reshape(num_chunks, chunk)
    for cta in range(p["grid"]):
        for c in range(cta, num_chunks, p["grid"]):
            norms[c] = t_cl.census_order(rows[c], chunk)[0]
    return norms


@pytest.mark.parametrize("chunk,num_chunks", [(32768, 5), (1024, 37),
                                              (12292, 4), (4, 9)])
def test_census_order_same_bits_at_any_grid(chunk, num_chunks):
    """The model gives the same bits at two grid sizes, and is the same
    |x| summed as the JAX package's census (its Pallas kernel in
    interpret mode, and its reference) and the port's plain version, up
    to f32 rounding (1e-6 relative)."""
    x = np.random.default_rng(7).standard_normal(
        num_chunks * chunk).astype(np.float32)
    x[:chunk] = 0.0  # an all-zero chunk sums to +0
    a = _census_at_grid(x, chunk, None)
    b = _census_at_grid(x, chunk, max(1, num_chunks // 3))
    assert a.tobytes() == b.tobytes()
    assert np.array_equal(a, t_cl.census_order(x, chunk))
    assert a[0] == 0.0 and not np.signbit(a[0])
    jx = jnp.asarray(x)
    for want in (j_cl.chunk_l1norm(jx, chunk, interpret=True),
                 j_ref.chunk_l1norm(jx, chunk),
                 t_cl.plain(torch.from_numpy(x), chunk)):
        np.testing.assert_allclose(a, np.asarray(want, np.float32),
                                   rtol=1e-6)

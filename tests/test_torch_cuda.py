"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode). The file imports neither ``jax``
nor the JAX package, so it runs where only PyTorch is installed (without
the JAX-importing conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_l1norm as t_cl
from repro_torch.kernels import csc_compact as t_cc
from repro_torch.kernels import ops
from repro_torch.kernels import pool_pack as t_pack
from repro_torch.kernels import pool_unpack as t_unpack

SIZES = (37, 128, 5, 300, 1, 77)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _table(sizes):
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return tuple(offsets), off


def _randn(seed, n):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


@pytest.mark.cuda
def test_cuda_kernels_match_plain(dev):
    """The pool kernels on ragged leaves with padding, a census, and
    mixed dtypes; the update with a random mask and a padding tail."""
    offsets, covered = _table(SIZES)
    pool_size = -(-covered // 64) * 64 + 64
    tl = [_randn(i, s).to(dev, torch.float32 if i % 2 else torch.bfloat16)
          for i, s in enumerate(SIZES)]
    for wire in (torch.bfloat16, torch.float32):
        for chunk in (0, 64):
            got, norms = t_pack.launch(tl, offsets, SIZES, pool_size, chunk,
                                       wire)
            want, want_n = t_pack.plain(tl, offsets, SIZES, pool_size, chunk,
                                        wire)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            if chunk:
                torch.testing.assert_close(norms, want_n, rtol=1e-6, atol=0)
    sizes = (37, 128, 5, 300, 77)
    offsets, covered = _table(sizes)
    n = covered + 11
    master, grads, mom = (_randn(10 + i, n).to(dev) for i in range(3))
    mask = _randn(13, n).to(dev) > -0.5
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4)
    got_l, got_m = t_unpack.launch(master, grads, mom, mask, offsets, sizes,
                                   **kw)
    want_l, want_m = t_unpack.plain(master, grads, mom, mask, offsets, sizes,
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m)
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    # A span with no leaf (CSC's padding-only last span): momentum only.
    got_l, got_m = t_unpack.launch(master, grads, mom, mask, (), (), **kw)
    want_l, want_m = t_unpack.plain(master, grads, mom, mask, (), (), **kw)
    torch.cuda.synchronize()
    assert got_l == [] and want_l == [] and torch.equal(got_m, want_m)


@pytest.mark.cuda
def test_cuda_csc_kernels_match_plain(dev):
    """The census (deterministic, 1e-6 relative) and the gather (bit for
    bit), f32 and bf16: rows smaller than a stage (1024), rows of whole
    stages (32768) and of a stage and a half and 16 bytes (12292), rows
    that are not a multiple of 16 bytes (33), and views at an odd element
    offset; the gather at k = 1 and k = 616 of 32768-element rows, and at
    a grid far below its items."""
    for dtype in (torch.float32, torch.bfloat16):
        for chunk, num_chunks in ((1024, 37), (33, 20), (12292, 9),
                                  (32768, 6)):
            x = _randn(7, chunk * num_chunks).to(dev, dtype)
            got = t_cl.launch(x, chunk)
            again = t_cl.launch(x, chunk)
            want = t_cl.plain(x, chunk)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            assert torch.equal(got, again)
            idx = torch.tensor([0, 3, 4, num_chunks - 1], device=dev)
            assert torch.equal(t_cc.launch(x, idx, chunk),
                               t_cc.plain(x, idx, chunk))
            assert torch.equal(t_cc.launch(x, idx, chunk, grid=1),
                               t_cc.plain(x, idx, chunk))
            # A view at an odd element offset takes a narrower copy unit.
            view = x[1:1 + chunk * (num_chunks - 1)]
            assert torch.equal(t_cc.launch(view, idx[:3], chunk),
                               t_cc.plain(view, idx[:3], chunk))
            assert torch.equal(t_cl.launch(view, chunk),
                               t_cl.launch(view, chunk))
            torch.testing.assert_close(t_cl.launch(view, chunk),
                                       t_cl.plain(view, chunk), rtol=1e-6,
                                       atol=0)
    chunk, num_chunks = 32768, 700
    pool = _randn(8, chunk * num_chunks).to(dev)
    rng = np.random.default_rng(9)
    for k in (1, 616):
        idx = torch.from_numpy(np.sort(rng.choice(num_chunks, k,
                                                  replace=False))).to(dev)
        want = t_cc.plain(pool, idx, chunk)
        for grid in (None, 3):
            got = t_cc.launch(pool, idx, chunk, grid=grid)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, grid)
        assert torch.equal(want, torch.index_select(
            pool.view(num_chunks, chunk), 0, idx).reshape(-1))


@pytest.mark.cuda
def test_cuda_census_same_bits_at_any_grid(dev):
    """The census's bulk path sums each chunk in an order fixed by the
    chunk's length alone: the same bits at 1, 7 and the plan's CTAs, and
    the bits of its numpy model (``census_order``); the block path (bf16)
    the same bits at two grids."""
    for chunk, num_chunks in ((32768, 300), (1024, 37), (12292, 9)):
        x = _randn(11, chunk * num_chunks).to(dev)
        x[:chunk] = 0.0
        norms = [t_cl.launch(x, chunk, grid=g) for g in (None, 1, 7)]
        torch.cuda.synchronize()
        assert all(torch.equal(norms[0], n) for n in norms[1:])
        model = t_cl.census_order(x.cpu().numpy(), chunk)
        assert norms[0].cpu().numpy().tobytes() == model.tobytes()
        b = x.to(torch.bfloat16)
        assert torch.equal(t_cl.launch(b, chunk), t_cl.launch(b, chunk,
                                                               grid=3))


@pytest.mark.cuda
def test_cuda_pack_vector_and_element_paths(dev):
    """The pack's 16-byte path (a table of 8-aligned offsets, every tile
    of a pool several grids long), its element path (a leaf that is a
    view one element into its storage: a misaligned source; odd sizes),
    a tile crossed by more segment runs than it stages, bf16 and f32
    sources, both wires, with and without the census: bit for bit against
    the plain pack, and the same census bits on two launches."""
    tables = {
        "aligned": (8, 1024, 64, 40_000, 4096, 24),
        "odd": (37, 128, 5, 300, 1, 77),
        "many runs": tuple(1 + i % 5 for i in range(700)),
        "large": (3_000_000, 8, 1_500_016, 6_000_000),
    }
    for label, sizes in tables.items():
        offsets, covered = _table(sizes)
        chunk = 4096
        pool_size = -(-covered // chunk) * chunk + chunk
        for src in (torch.float32, torch.bfloat16):
            base = [_randn(i, s + 1).to(dev, src)
                    for i, s in enumerate(sizes)]
            aligned = [b[:s] for b, s in zip(base, sizes)]
            shifted = [b[1:] for b in base]  # one element in: misaligned
            for leaves in (aligned, shifted):
                for wire in (torch.bfloat16, torch.float32):
                    for ch in (0, chunk):
                        args = (leaves, offsets, sizes, pool_size, ch, wire)
                        got, norms = t_pack.launch(*args)
                        again, norms2 = t_pack.launch(*args)
                        want, want_n = t_pack.plain(*args)
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), (label, src, wire, ch)
                        assert torch.equal(again, want)
                        if ch:
                            torch.testing.assert_close(norms, want_n,
                                                       rtol=1e-6, atol=0)
                            assert torch.equal(norms, norms2)


_BAD_INDEX = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, {src!r})
    from repro_torch.kernels import csc_compact
    pool = torch.zeros(4 * 64, device="cuda")
    csc_compact.launch(pool, torch.tensor([1, 4], device="cuda"), 64)
    torch.cuda.synchronize()
    print("no error")
""")


@pytest.mark.cuda
def test_cuda_csc_compact_traps_on_bad_index(dev):
    """An index past the last chunk stops the kernel with a CUDA error at
    the next synchronisation (in a subprocess: the trap ends its CUDA
    context)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    proc = subprocess.run([sys.executable, "-c", _BAD_INDEX.format(src=src)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no error" not in proc.stdout
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr


@pytest.mark.cuda
def test_cuda_csc_trainer_kernels_match_plain(dev):
    """The smoke-size CSC Trainer on the card, dense warm-up then sparse
    stages: with the kernels it launches only kernels and follows the run
    without them (the census sums in another order: rtol 1e-5). Attention
    is the model's, not the pool's: both runs take the flash-attention
    kernel, each layer's forward and its remat recompute a step."""
    from repro_torch.configs import base, get_smoke
    from repro_torch.launch.trainer import Trainer

    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(t[:, :-1]),
                "labels": torch.from_numpy(t[:, 1:])}
               for t in (rng.integers(0, 256, (2, 33)) for _ in range(4))]
    runs = []
    for use_kernels in (True, False):
        cfg = base.TrainConfig(
            model=model, seq_len=32, global_batch=2, attn_chunk=0,
            gradientflow=base.GradientFlowConfig(
                mode="csc", bucket_elems=8192, wire_dtype="float32",
                chunk_elems=1024, sparsity=0.5, warmup_steps=2,
                warmup_stages=2, use_kernels=use_kernels),
            optimizer=base.OptimizerConfig(learning_rate=0.1,
                                           warmup_steps=2, total_steps=4))
        trainer = Trainer(cfg, device=dev)
        state = trainer.init_state(seed=0)
        ops.reset_counts()
        losses = []
        for i, b in enumerate(batches):
            step = trainer.build_train_step(trainer.gf.stage_for_step(i))
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        runs.append((losses, [p.cpu() for p in
                              trainer.pool.flat_leaves(state.params)],
                     dict(ops.dispatch_counts)))
    (k_loss, k_params, k_counts), (p_loss, p_params, p_counts) = runs
    attn = 2 * model.num_layers * len(batches)
    assert k_counts.pop("flash_attention.kernel") == attn
    assert set(k_counts) == {"pool_pack.kernel", "pool_unpack_update.kernel",
                             "chunk_l1norm.kernel", "csc_compact.kernel"}
    assert k_counts["csc_compact.kernel"] == 3 \
        and p_counts == {"flash_attention.kernel": attn}
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    for a, b in zip(k_params, p_params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# -- the ring and the whole-pool update ------------------------------------------

RING_WIRES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.int8, torch.int8),
              (torch.float8_e4m3fn, torch.float8_e4m3fn))


def ring_case(n, size, x_dtype, seed):
    """N ranks' inputs. int8 words within 127 // N (on the grid); fp8
    words anywhere in the format's range, so sums pass ±448 and the
    overflow rule is exercised."""
    rng = np.random.default_rng(seed)
    if x_dtype == torch.int8:
        q = 127 // n
        return [torch.from_numpy(rng.integers(-q, q + 1, size)
                                 .astype(np.int8)) for _ in range(n)]
    if x_dtype == torch.float8_e4m3fn:
        return [torch.from_numpy(rng.uniform(-448, 448, size)
                                 .astype(np.float32)).to(x_dtype)
                for _ in range(n)]
    return [torch.from_numpy(rng.standard_normal(size).astype(np.float32))
            .to(x_dtype) for _ in range(n)]


def _seq_words(ws):
    """Each rank's sequence word of lane 0 (the workspace's flag layout:
    full, credit, sequence words of every lane)."""
    out = []
    for w in ws:
        buf = w.keep[w.rank]
        at = 2 * w.lanes * 8
        out.append(int(buf[at:at + 8].view(torch.int64).item()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_cuda_ring_matches_plain(dev, n):
    """N ranks in one process, each on its own stream: every wire, sizes
    from one element to more than 2G sub-tiles a lane with a ragged last
    round, the same bits as the plain ring with the kernel's segment, on
    every rank; back to back over one workspace, whose sequence words
    carry over (lane 0 counts every launch's 2(N-1) sub-tiles a tile); and
    in place (out = x)."""
    from repro_torch.kernels import ring_reduce as t_ring

    ws = t_ring.RingWorkspace.in_process(n, dev)
    sms = t_ring._sms(dev)
    tile = t_ring.LANE_ELEMS * t_ring.max_lanes(n, sms)
    many = (2 * t_ring.ROUND_TILES + 1) * tile * n + 9
    seq = 0
    for size in (1, n * 5 + 3, 70_001, many):
        for k, (x_dtype, wire) in enumerate(RING_WIRES):
            xs = [x.to(dev) for x in ring_case(n, size, x_dtype, size + k)]
            p = t_ring.plan(size, n, wire, sms=sms)
            if size == many:
                assert p["tiles_per_segment"] > 2 * t_ring.ROUND_TILES
                assert p["tiles_per_segment"] % t_ring.ROUND_TILES
            want = t_ring.plain(xs, wire, p["seg_elems"])
            got = t_ring.launch_ranks(xs, ws, wire)
            seq += p["exchange_steps"] * p["tiles_per_segment"]
            in_place = [x.clone() for x in xs]
            t_ring.launch_ranks(in_place, ws, wire, outs=in_place)
            seq += p["exchange_steps"] * p["tiles_per_segment"]
            torch.cuda.synchronize()
            for r in range(n):
                for res in (got[r], in_place[r]):
                    assert torch.equal(res.view(torch.uint8),
                                       want[r].view(torch.uint8)), (
                        size, x_dtype, wire, r)
                assert torch.equal(got[r].view(torch.uint8),
                                   got[0].view(torch.uint8))
            assert _seq_words(ws) == [seq] * n, (size, x_dtype, wire)


@pytest.mark.cuda
def test_cuda_ring_occupancy(dev):
    """Every instance of the ring kernel fits CTAS_PER_SM CTAs on an SM,
    so the N ranks of a ring on one card are resident together (the
    launcher refuses to launch below that)."""
    from repro_torch.kernels import ring_reduce as t_ring

    for x_dtype in t_ring.DTYPE_CODES:
        for wire in t_ring.DTYPE_CODES:
            assert t_ring.occupancy(x_dtype, wire, dev) >= \
                t_ring.CTAS_PER_SM, (x_dtype, wire)


_RING_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=2, rank=rank)
    from test_torch_cuda import ring_case
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_reduce
    from repro_torch.parallel import topology
    from repro_torch.parallel import collectives
    dev = torch.device("cuda", 0)
    ops.ring_prepare(collectives.ring_levels(None), dev)
    saved = {{}}
    for size in (5, 70_001, 1_000_003):
        for k, dt in enumerate((torch.bfloat16, torch.float32)):
            x = ring_case(2, size, dt, size + k)[rank].to(dev)
            ops.reset_counts()
            y, work = topology.PALLAS_RING.reduce(x, None, async_op=True)
            work.wait()
            torch.cuda.synchronize()
            assert ops.dispatch_counts == {{"ring_allreduce.kernel": 1}}
            saved[f"{{size}}|{{k}}"] = y.view(torch.uint8).cpu().numpy()
    ring_reduce.release_workspaces()
    np.savez(out, **saved)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_cuda_ring_across_two_processes(dev, tmp_path):
    """Two processes on one card, one rank each, over the cross-process
    (CUDA IPC) workspace with a gloo group for the set-up: both ranks end
    with the plain ring's bits."""
    import socket

    tests = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "ring_worker.py"
    script.write_text(_RING_WORKER.format(
        tests=tests, src=os.path.join(tests, "..", "src")))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(tmp_path / f"r{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    from repro_torch.kernels import ring_reduce as t_ring
    for size in (5, 70_001, 1_000_003):
        for k, dt in enumerate((torch.bfloat16, torch.float32)):
            xs = ring_case(2, size, dt, size + k)
            want = t_ring.plain(xs)[0].view(torch.uint8).numpy()
            np.testing.assert_array_equal(r0[f"{size}|{k}"], want)
            np.testing.assert_array_equal(r1[f"{size}|{k}"], want)


@pytest.mark.cuda
def test_cuda_fused_update_matches_plain(dev):
    """With and without the scale, on 16-byte aligned pools and on views
    one element in (the element-wise path), bit for bit."""
    from repro_torch.kernels import fused_update as t_fu

    n = 100_003
    master, grads, mom, scale = (_randn(20 + i, n + 1).to(dev)
                                 for i in range(4))
    mask = _randn(30, n + 1).to(dev) > 0.3
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4)
    for off in (0, 1):
        args = [t[off:off + n] for t in (master, grads, mom, mask)]
        for s in (None, scale[off:off + n]):
            got = t_fu.launch(*args, scale=s, **kw)
            want = t_fu.plain(*args, scale=s, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


@pytest.mark.cuda
def test_cuda_update_whole_padded_pool_with_ratios(dev):
    """The monolithic LARS update: one launch over a whole pool padded to
    a chunk multiple, a chunk-granular mask, the per-tensor ratios with
    the trailing padding entry (f32[T+1]), written into the leaves and
    the momentum in place, bit for bit against the plain version."""
    sizes, chunk = (37, 128, 5, 300, 77), 64
    offsets, covered = _table(sizes)
    n = -(-covered // chunk) * chunk
    assert n > covered
    master, grads, mom = (_randn(40 + i, n).to(dev) for i in range(3))
    mask = (_randn(43, n // chunk) > 0).to(dev).repeat_interleave(chunk)
    ratios = _randn(44, len(sizes) + 1).abs().to(dev)
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4, ratios=ratios)
    leaves = [torch.empty(s, device=dev) for s in sizes]
    mom_out = mom.clone()
    got_l, got_m = t_unpack.launch(master, grads, mom_out, mask, offsets,
                                   sizes, out_leaves=leaves,
                                   out_momentum=mom_out, **kw)
    want_l, want_m = t_unpack.plain(master, grads, mom, mask, offsets, sizes,
                                    **kw)
    torch.cuda.synchronize()
    assert got_m is mom_out and all(a is b for a, b in zip(got_l, leaves))
    assert torch.equal(got_m, want_m)
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))


@pytest.mark.cuda
def test_cuda_update_padding_span_with_empty_ratios(dev):
    """CSC's padding-only span under LARS: the view has no tensor, so its
    ratios vector is empty. A fresh empty tensor hands the C side a null
    pointer and an empty slice a non-null one with n_ratios = 0; either
    way the padding takes the ratio 1.0, as the plain version does."""
    n = 1000
    master, grads, mom = (_randn(50 + i, n).to(dev) for i in range(3))
    mask = _randn(53, n).to(dev) > 0
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4)
    want_l, want_m = t_unpack.plain(master, grads, mom, mask, (), (),
                                    ratios=torch.zeros(0, device=dev), **kw)
    unscaled = t_unpack.plain(master, grads, mom, mask, (), (), **kw)[1]
    assert want_l == [] and torch.equal(want_m, unscaled)
    fresh = torch.zeros(0, device=dev)
    for r in (fresh, _randn(54, 8).to(dev)[3:3]):
        assert r.numel() == 0
        got_l, got_m = t_unpack.launch(master, grads, mom, mask, (), (),
                                       ratios=r, **kw)
        torch.cuda.synchronize()
        assert got_l == [] and torch.equal(got_m, want_m), r.data_ptr()


@pytest.mark.cuda
def test_cuda_update_ok_predicate(dev):
    """The guard's predicate at a ragged size, with and without ratios:
    ok = true gives the launch without ok bit for bit; ok = false writes
    nothing (NaN gradients included); outputs that are not the live
    tensors are refused."""
    sizes = (37, 128, 5, 300, 77)
    offsets, covered = _table(sizes)
    n = covered + 11
    master, grads, mom = (_randn(60 + i, n).to(dev) for i in range(3))
    mask = _randn(63, n).to(dev) > -0.5
    nan = torch.full_like(grads, float("nan"))
    for ratios in (None, _randn(64, len(sizes) + 1).abs().to(dev)):
        kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
                  weight_decay=1e-4, ratios=ratios)
        want_l, want_m = t_unpack.plain(master, grads, mom, mask, offsets,
                                        sizes, **kw)
        for ok in (True, False):
            leaves = [_randn(70 + i, s).to(dev) for i, s in enumerate(sizes)]
            old = [x.clone() for x in leaves]
            m = mom.clone()
            got_l, got_m = t_unpack.launch(
                master, grads if ok else nan, m, mask, offsets, sizes,
                out_leaves=leaves, out_momentum=m,
                ok=torch.tensor([ok], device=dev), **kw)
            torch.cuda.synchronize()
            ref_l, ref_m = (want_l, want_m) if ok else (old, mom)
            assert torch.equal(got_m.view(torch.uint8),
                               ref_m.view(torch.uint8)), (ok, ratios)
            assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(got_l, ref_l)), (ok, ratios)
        with pytest.raises(ValueError, match="live parameters"):
            t_unpack.launch(master, grads, mom, mask, offsets, sizes,
                            ok=torch.tensor([True], device=dev), **kw)


def _same_class(got, want):
    """NaN where the plain version has NaN (any NaN word), the same bits
    everywhere else."""
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        got.element_size()]
    assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.cuda
def test_cuda_nonfinite_words_by_class(dev):
    """NaN, +-Inf and 2^120 words through the pack (to bf16 and to f32),
    the census of the packed pool and the ring at N = 2 with a NaN on one
    rank, against the plain versions by class: no kernel turns a NaN or
    an Inf into a finite word."""
    from repro_torch.kernels import ring_reduce as t_ring

    sizes, chunk = (37, 128, 5, 300, 77), 64
    offsets, covered = _table(sizes)
    pool_size = -(-covered // chunk) * chunk
    leaves = [_randn(80 + i, s).to(dev) for i, s in enumerate(sizes)]
    for (leaf, at), v in zip(((0, 3), (1, 100), (3, 7), (4, 0), (2, 1)),
                             (float("nan"), float("inf"), -float("inf"),
                              2.0 ** 120, float("nan"))):
        leaves[leaf][at] = v
    for wire in (torch.bfloat16, torch.float32):
        got, _ = t_pack.launch(leaves, offsets, sizes, pool_size, 0, wire)
        want, _ = t_pack.plain(leaves, offsets, sizes, pool_size, 0, wire)
        torch.cuda.synchronize()
        _same_class(got, want)
        norms = t_cl.launch(got, chunk)
        want_n = t_cl.plain(got, chunk)
        torch.cuda.synchronize()
        for cls in (torch.isnan, torch.isinf):
            assert torch.equal(cls(norms), cls(want_n)), (wire, cls)
        fin = torch.isfinite(want_n)
        assert fin.sum() < fin.numel()
        torch.testing.assert_close(norms[fin], want_n[fin], rtol=1e-6,
                                   atol=0)
    xs = [x.to(dev) for x in ring_case(2, 70_001, torch.bfloat16, 9)]
    xs[0][123] = float("nan")
    xs[0][60_000] = 2.0 ** 120
    xs[1][5_000] = float("inf")
    ws = t_ring.RingWorkspace.in_process(2, dev)
    p = t_ring.plan(70_001, 2, torch.bfloat16, sms=t_ring._sms(dev))
    got = t_ring.launch_ranks(xs, ws, torch.bfloat16)
    want = t_ring.plain(xs, torch.bfloat16, p["seg_elems"])
    torch.cuda.synchronize()
    for r in range(2):
        _same_class(got[r], want[r])
        assert torch.isnan(got[r][123].float()) and \
            torch.isinf(got[r][5_000].float())
        assert torch.equal(got[r].view(torch.int16), got[0].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_cuda_wire_matches_cpu(dev, fmt):
    """The low-bit wire's PyTorch ops on the card against the same
    functions on the CPU, from the same census: the scales, the words,
    the error (the residual's new value), the dequantized pool and a
    bucket's dequantized segment bit for bit (round half to even, IEEE
    f32 division and products on both)."""
    from repro_torch.core import wire

    spec = wire.resolve(fmt)
    chunk, chunks, n = 256, 24, 4
    rng = np.random.default_rng(5)
    g = (rng.standard_normal(chunk * chunks) *
         rng.choice([1e-4, 1e-2, 1.0, 40.0], chunk * chunks)).astype(
             np.float32)
    g[:chunk] = 0.0
    census = torch.from_numpy(np.abs(g).reshape(chunks, chunk)
                              .sum(1, dtype=np.float32) * n)
    outs = {}
    for d in ("cpu", dev):
        s = wire.scales_from_census(census.to(d), chunk_elems=chunk,
                                    num_shards=n, spec=spec)
        q, err = wire.quantize_pool(torch.from_numpy(g).to(d), s,
                                    chunk_elems=chunk, spec=spec,
                                    num_shards=n)
        deq = wire.dequantize_pool(q, s, chunk)
        seg = wire.dequantize_segment(q[300:3001].to(torch.float32), s,
                                      300, 3001, chunk)
        outs[str(d)] = [x.cpu() for x in (s, q, err, deq, seg)]
    torch.cuda.synchronize()
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    q = outs["cpu"][1].to(torch.float32)
    assert q.abs().max() == wire.rank_clip(spec, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_ring_sums_quantized_int8_words_exactly(dev, n):
    """N ranks' int8 words from ``quantize_pool`` (scales from their
    summed census) through the ring kernel: every rank gets the flat
    integer sum bit for bit, the grid being exact."""
    from repro_torch.core import wire
    from repro_torch.kernels import ring_reduce as t_ring

    spec = wire.resolve("int8")
    chunk = 1024
    gs = [_randn(40 + r, 333 * chunk).to(dev) * (r + 1) for r in range(n)]
    census = sum(wire.chunk_l1(g, chunk) for g in gs)
    s = wire.scales_from_census(census, chunk_elems=chunk, num_shards=n,
                                spec=spec)
    qs = [wire.quantize_pool(g, s, chunk_elems=chunk, spec=spec,
                             num_shards=n)[0] for g in gs]
    flat = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
    assert flat.abs().max() <= 127
    ws = t_ring.RingWorkspace.in_process(n, dev)
    got = t_ring.launch_ranks(qs, ws)
    torch.cuda.synchronize()
    for r in range(n):
        assert got[r].dtype == torch.int8
        assert torch.equal(got[r].to(torch.int32), flat), r


# -- the window as a CUDA graph -------------------------------------------------


def _window_cfg(mode, tail, guarded, opt="momentum_sgd", wire="native",
                overlap="staged", microbatches=1):
    from repro_torch.configs import base, get_smoke

    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model, seq_len=16, global_batch=2, attn_chunk=0,
        microbatches=microbatches,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=4096, chunk_elems=512, sparsity=0.5,
            warmup_steps=0, wire_dtype="float32", pipeline_tail_buckets=tail,
            guard=base.GuardConfig(init_scale=2.0, growth_interval=1000)
            if guarded else None, use_kernels=True, wire_format=wire,
            overlap=overlap),
        optimizer=base.OptimizerConfig(
            name=opt, learning_rate=0.01 if opt == "adamw" else 0.1,
            warmup_steps=2, total_steps=16, schedule="constant"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tail,guarded,extra", [
    ("lazy", 0, False, {}), ("lazy", 2, False, {}), ("lazy", 2, True, {}),
    ("dense", 2, False, {}), ("csc", 0, True, {}),
    ("lazy", 0, False, {"opt": "lars"}), ("csc", 0, False, {"opt": "lars"}),
    ("lazy", 0, False, {"opt": "adamw"}), ("csc", 0, True, {"opt": "adamw"}),
    ("lazy", 0, False, {"wire": "int8"}), ("csc", 0, True, {"wire": "int8"}),
    ("lazy", 0, False, {"wire": "fp8_e4m3"}),
    ("lazy", 0, False, {"overlap": "monolithic"}),
    ("lazy", 0, True, {"opt": "lars", "overlap": "monolithic"}),
    ("lazy", 2, True, {"microbatches": 2}),
    ("csc", 0, True, {"microbatches": 2, "wire": "int8"})],
    ids=lambda v: "-".join(map(str, v.values())) if isinstance(v, dict)
    else str(v))
def test_cuda_window_graph_matches_eager(dev, mode, tail, guarded, extra):
    """Two K = 4 windows, each a replay of one CUDA graph, against 8
    eager per-step steps from the same seed on the same batches, for
    momentum SGD, LARS and AdamW, the native, int8 and fp8 wires, staged
    and monolithic overlap, one and two microbatches: the losses and every
    tensor of the state
    (parameters, optimizer state, hg, chunk norms, residual, scaler) the
    same bits (guarded: a NaN at step 5 trips only step 5); the capture's
    launches are 4 x the per-step plan's; the pipelined window's state is
    flushed."""
    from repro_torch.launch.trainer import Trainer, is_flushed
    from repro_torch.runtime.faults import FaultEvent, make_hook

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (8, 2, 17)))
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    hook = make_hook([FaultEvent(step=5, kind="nan", offset=8, width=4)]) \
        if guarded else None
    cfg = _window_cfg(mode, tail, guarded, **extra)
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(seed=0)
    window = trainer.build_train_window(4, fault_hook=hook)
    losses, tripped = [], []
    for w in range(2):
        state, m = window(state, {k: v[4 * w:4 * w + 4]
                                  for k, v in batches.items()})
        losses += m["loss"].tolist()
        tripped += m["guard_tripped"].tolist() if guarded else []
    assert is_flushed(state) and state.step == 8
    assert window.stats["captures"] == 1 and window.stats["replays"] == 2
    eager = Trainer(_window_cfg(mode, 0, guarded, **extra), device=dev)
    ref = eager.init_state(seed=0)
    step = eager.build_train_step(fault_hook=hook)
    ops.reset_counts()
    ref_losses = []
    for i in range(8):
        ref, m = step(ref, {k: v[i] for k, v in batches.items()})
        ref_losses.append(float(m["loss"]))
        if i == 3:
            per_4 = dict(ops.dispatch_counts)
    assert losses == ref_losses
    if guarded:
        assert tripped == [float(i == 5) for i in range(8)]

    def tensors(t, st):
        return (t.pool.flat_leaves(st.params) + list(st.opt) + list(st.gf)
                + (list(st.guard) if st.guard else []))

    got_t, want_t = tensors(trainer, state), tensors(eager, ref)
    assert len(got_t) == len(want_t)
    for a, b in zip(got_t, want_t):
        assert torch.equal(a, b)
    got = window.stats["capture_counts"]
    if tail:
        # The tail spans' updates move to the lane apply at each step's
        # start and the flush, each with a master pack of its span.
        per_4 = dict(per_4)
        per_4["pool_pack.kernel"] += tail * 5
        per_4["pool_unpack_update.kernel"] += tail
    assert got == per_4
    window.release()


@pytest.mark.cuda
def test_cuda_replay_record_carries_the_capture_counts(dev):
    """A K = 4 CSC window: the first call's record holds the warm-up
    body's and the capture's launches (the device ran the warm-up and one
    replay); the second call, a replay alone, leaves ``dispatch_counts``
    as it was (the graph is counted once, at capture) while its record
    holds the capture's launches, the work the replay ran."""
    from repro_torch.launch.trainer import Trainer
    from repro_torch.runtime import trace

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (8, 2, 17)))
    batches = [{"tokens": toks[i:i + 4, :, :-1],
                "labels": toks[i:i + 4, :, 1:]} for i in (0, 4)]
    trainer = Trainer(_window_cfg("csc", 0, False), device=dev)
    state = trainer.init_state(seed=0)
    window = trainer.build_train_window(4)
    state, _ = window(state, batches[0])
    first = trace.records[-1]
    assert first["steps"] == 4
    want = dict(window.stats["warmup_counts"])
    for k, v in window.stats["capture_counts"].items():
        want[k] = want.get(k, 0) + v
    assert first["counts"]["dispatch"] == want
    assert set(first["counts"]["launch"]) == {"warmup_s", "capture_s"}
    assert all(v > 0 for v in first["counts"]["launch"].values())
    counts = dict(ops.dispatch_counts)
    before = trace.snapshot()
    state, m = window(state, batches[1])
    m["loss"].tolist()
    rec = trace.records[-1]
    assert ops.dispatch_counts == counts
    assert trace.delta(trace.snapshot(), before) == {}
    assert rec["steps"] == 4
    assert rec["counts"] == {"dispatch": window.stats["capture_counts"]}
    window.release()


@pytest.mark.cuda
def test_cuda_capture_needs_the_arena(dev):
    """A launch whose segment table comes from the host refuses to be
    captured outside ``build.capture_arena`` (a replay would read freed
    host memory); inside one it is captured and replays right."""
    from repro_torch.kernels import build

    sizes = (37, 128, 5)
    offsets, n = _table(sizes)
    leaves = [torch.randn(s, device=dev) for s in sizes]
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture_arena"):
        with torch.cuda.graph(g):
            ops.pool_pack(leaves, offsets, sizes, n, 0, torch.float32)
    g = torch.cuda.CUDAGraph()
    arena = build.HostArena(4096)
    with build.capture_arena(arena), torch.cuda.graph(g):
        pool, _ = ops.pool_pack(leaves, offsets, sizes, n, 0, torch.float32)
    for _ in range(2):
        for x in leaves:
            x.normal_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(pool, torch.cat(leaves))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_cuda_window_replays_after_in_place_restore(dev, mode, tmp_path):
    """A K = 4 window: windows 0-3 and 4-7 with a checkpoint at 4, then a
    restore of step 4 into the live state (in place, the same tensors)
    and window 4-7 again: the same losses and state bits as the first
    pass, from the one graph captured at the first call (no new
    capture). After ``Trainer.replan`` the window refuses to replay."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.trainer import Trainer

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (8, 2, 17)))
    batches = [{"tokens": toks[i:i + 4, :, :-1], "labels": toks[i:i + 4, :, 1:]}
               for i in (0, 4)]
    trainer = Trainer(_window_cfg(mode, 0, False), device=dev)
    state = trainer.init_state(seed=0)
    window = trainer.build_train_window(4)
    ckpt = CheckpointManager(str(tmp_path))
    state, _ = window(state, batches[0])
    ckpt.save(4, state, blocking=True)
    state, m = window(state, batches[1])
    first = (m["loss"].tolist(),
             [t.clone() for t in trainer.pool.flat_leaves(state.params)]
             + [t.clone() for t in list(state.opt) + list(state.gf)])
    ptrs = [t.data_ptr() for t in trainer.pool.flat_leaves(state.params)]
    step, state = ckpt.restore(state)
    assert step == 4 and state.step == 4
    assert [t.data_ptr() for t in
            trainer.pool.flat_leaves(state.params)] == ptrs
    state, m = window(state, batches[1])
    again = (m["loss"].tolist(),
             trainer.pool.flat_leaves(state.params)
             + list(state.opt) + list(state.gf))
    assert again[0] == first[0]
    for a, b in zip(again[1], first[1]):
        assert torch.equal(a, b)
    assert window.stats["captures"] == 1 and window.stats["replays"] == 3
    trainer.replan()
    with pytest.raises(ValueError, match="replan"):
        window(state, batches[0])
    window.release()


# -- blockwise attention --------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("causal,skip", [(True, True), (True, False),
                                         (False, False)])
def test_cuda_blockwise_attention_matches_cpu(dev, causal, skip,
                                              monkeypatch):
    """Blockwise attention (PyTorch ops, no kernel of the repo) on the
    card against the same function on the CPU, f32 with TF32 off: the
    output and the q, k, v gradients to rtol 1e-5, atol 1e-5 (the two
    devices' f32 products and exponentials differ in the last bits)."""
    from repro_torch.models.layers import attention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.standard_normal((2, 256, 4, 32))
                           .astype(np.float32)) for _ in range(4)]

    def run(device):
        q, k, v = [x.to(device).requires_grad_(True) for x in xs[:3]]
        out = attention.blockwise_attention(q, k, v, causal=causal,
                                            chunk_q=64, chunk_k=64,
                                            causal_skip=skip)
        grads = torch.autograd.grad(out, (q, k, v),
                                    grad_outputs=xs[3].to(device))
        return [t.detach().cpu() for t in (out,) + grads]

    for got, want in zip(run(dev), run("cpu")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_cuda_blockwise_microbatched_window_matches_eager(dev):
    """olmo-smoke through blockwise attention (sequence 128, chunks of
    64) at microbatches 2: a K = 4 window as a CUDA graph against four
    eager steps on the same batches, the same losses and state bits."""
    from repro_torch.configs import base, get_smoke
    from repro_torch.launch.trainer import Trainer

    cfg = base.TrainConfig(
        model=dataclasses.replace(get_smoke("olmo-1b")[0],
                                  compute_dtype="float32"),
        seq_len=128, global_batch=4, microbatches=2, attn_chunk=64,
        gradientflow=base.GradientFlowConfig(
            mode="lazy", bucket_elems=65536, wire_dtype="float32",
            use_kernels=True),
        optimizer=base.OptimizerConfig(learning_rate=0.1, warmup_steps=1,
                                       total_steps=8, schedule="constant"))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, 4, 129)))
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    trainer = Trainer(cfg, device=dev)
    state, m = trainer.build_train_window(4)(trainer.init_state(seed=0),
                                             batches)
    eager = Trainer(cfg, device=dev)
    ref = eager.init_state(seed=0)
    step = eager.build_train_step()
    ref_losses = []
    for i in range(4):
        ref, r = step(ref, {k: v[i] for k, v in batches.items()})
        ref_losses.append(float(r["loss"]))
    assert m["loss"].tolist() == ref_losses
    for a, b in zip(trainer.pool.flat_leaves(state.params)
                    + [state.opt.momentum],
                    eager.pool.flat_leaves(ref.params) + [ref.opt.momentum]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_cuda_moe_layer_matches_cpu(dev, arch):
    """The MoE layer at smoke width in f32 (TF32 off), card against CPU
    from the same weights, with planted ties (zero tokens; two equal
    router columns) at capacity factor 0.5: the same expert indices and
    kept slots, the outputs, aux loss and every gradient within 1e-5 of
    the largest value."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.layers import moe

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch)[0]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(3)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else v.init(gen, v.shape)
                for k, v in tree.items()}
    params = draw(moe.spec(cfg))
    params["router"][:, 1] = params["router"][:, 0]
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    x.view(-1, cfg.d_model)[::5] = 0.0
    r = torch.randn(x.shape, generator=gen)

    def run(where):
        p = {k: ({j: w.to(where).requires_grad_(True) for j, w in v.items()}
                 if isinstance(v, dict) else v.to(where).requires_grad_(True))
             for k, v in params.items()}
        xx = x.to(where).requires_grad_(True)
        gates, idx, _ = moe.gate(p, xx.reshape(-1, cfg.d_model), cfg)
        _, kept = moe.slots(idx, cfg.moe.num_experts,
                            moe.capacity(cfg, 128))
        y, aux = moe.apply(p, xx, cfg)
        (torch.sum(y * r.to(where)) + aux).backward()
        leaves = [p[k] for k in ("router", "wi_gate", "wi_up", "wo")] + (
            list(p["residual"].values()) if "residual" in p else [])
        return ([idx.cpu(), kept.cpu()],
                [y.detach().cpu(), aux.detach().cpu(), xx.grad.cpu()]
                + [w.grad.cpu() for w in leaves])

    try:
        (i1, k1), card = run(dev)
        (i0, k0), cpu = run("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(i1, i0) and torch.equal(k1, k0)
    assert not k0.all()
    for got, want in zip(card, cpu):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "internvl2-26b",
                                  "musicgen-large"])
def test_cuda_family_window_matches_eager(dev, arch):
    """A K = 4 window as a CUDA graph (MoE routing and dispatch captured;
    the vlm's bf16 vision embeddings and the audio (B, S, K) tokens in
    its static inputs) against four eager steps on the same batches: the
    same losses and state bits."""
    from repro_torch.configs import base, get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.trainer import Trainer
    from repro_torch.models import registry

    cfg = base.TrainConfig(
        model=dataclasses.replace(get_smoke(arch)[0],
                                  compute_dtype="float32"),
        seq_len=32, global_batch=4,
        gradientflow=base.GradientFlowConfig(
            mode="lazy", bucket_elems=65536, wire_dtype="float32",
            use_kernels=True),
        optimizer=base.OptimizerConfig(learning_rate=0.1, warmup_steps=1,
                                       total_steps=8, schedule="constant"))
    gen = torch.Generator().manual_seed(7)
    steps = [registry.make_batch(cfg.model, ShapeConfig(seq_len=32), 4, gen)
             for _ in range(4)]
    batches = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
    trainer = Trainer(cfg, device=dev)
    window = trainer.build_train_window(4)
    state, m = window(trainer.init_state(seed=0), batches)
    assert window.stats["captures"] == 1
    eager = Trainer(cfg, device=dev)
    ref = eager.init_state(seed=0)
    step = eager.build_train_step()
    ref_losses = []
    for b in steps:
        ref, r = step(ref, b)
        ref_losses.append(float(r["loss"]))
    assert m["loss"].tolist() == ref_losses
    for a, b in zip(trainer.pool.flat_leaves(state.params)
                    + [state.opt.momentum],
                    eager.pool.flat_leaves(ref.params) + [ref.opt.momentum]):
        assert torch.equal(a, b)
    window.release()


# -- flash attention --------------------------------------------------------

# (b, s, h, hd): olmo-1b's heads at its context, musicgen-large's heads
# at its 1500 frames (a ragged last tile), stablelm-12b's 160-wide heads
# (padded to 256) at a ragged 333, a smoke configuration's 16-wide heads.
FLASH_SHAPES = [(2, 2048, 16, 128), (2, 1500, 32, 64), (2, 333, 4, 160),
                (2, 300, 4, 16)]
# The kernels against their plain version, both from the same bf16
# inputs: QK^T is the same exact products summed in f32 in another order,
# so the f32 log-sum-exp agrees to a few f32 ulps of the row's largest
# score (bound 2^-14 absolute: scores here reach ~|30|, whose ulp is
# 2^-19). P is rounded to bf16 from f32 values that differ in their last
# bits, so a P entry near a rounding boundary lands one bf16 ulp (2^-8
# relative) apart, and o, dq, dk, dv are rounded to bf16 at the end:
# every output within 2^-6 of the plain version's largest |value| (two
# bf16 ulps of it; (z)'s bound for the port's bf16 forms), and within
# 2^-7 relative RMS over the whole tensor (about one ulp's RMS).
FLASH_MAX_TOL = 2.0 ** -6
FLASH_RMS_TOL = 2.0 ** -7
FLASH_LSE_TOL = 2.0 ** -14


def _flash_inputs(dev, shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dev, dtype)
            for _ in range(4)]


def _flash_close(got, want, label):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rms = ((got - want).pow(2).mean().sqrt()
           / want.pow(2).mean().sqrt()).item()
    assert err <= FLASH_MAX_TOL * scale, (label, err, scale)
    assert rms <= FLASH_RMS_TOL, (label, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_cuda_flash_attention_matches_plain(dev, shape):
    """The forward's o and log-sum-exp and the backward's dq, dk, dv
    against the plain version's, bf16, at the configurations' head dims
    and lengths."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, shape)
    o, lse = fa.launch(q, k, v)
    want_o, want_lse = fa.plain(q, k, v)
    grads = fa.launch_backward(q, k, v, o, lse, do)
    want_grads = fa.plain_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert o.shape == shape and o.is_contiguous() and lse.shape == (
        shape[0], shape[2], shape[1])
    assert (lse - want_lse).abs().max().item() <= FLASH_LSE_TOL
    _flash_close(o, want_o, "o")
    for label, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert g.shape == shape and g.is_contiguous()
        _flash_close(g, w, label)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_matches_full_attention(dev):
    """f32 inputs run the products in full f32: o and the gradients
    within 1e-5 of full attention's (f32 sums in another order)."""
    from repro_torch.models.layers import attention

    q, k, v, do = _flash_inputs(dev, (2, 200, 4, 32), torch.float32)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    got = [ops.flash_attention(*leaves)]
    got += torch.autograd.grad(got[0], leaves, do)
    want = [attention.full_attention(*leaves, causal=True)]
    want += torch.autograd.grad(want[0], leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_repeats_bits(dev):
    """Two runs of the forward and backward give the same bits (no
    atomics)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, (2, 1500, 8, 64), seed=1)
    runs = []
    for _ in range(2):
        o, lse = fa.launch(q, k, v)
        runs.append((o, lse) + fa.launch_backward(q, k, v, o, lse, do))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_flash_attention_under_checkpoint(dev):
    """Under ``torch.utils.checkpoint`` (the layers' remat) the gradients
    are the same bits as without, and the forward launches twice."""
    import torch.utils.checkpoint

    q, k, v, do = _flash_inputs(dev, (2, 512, 4, 128), seed=2)

    def grads(remat):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        fn = ops.flash_attention
        out = torch.utils.checkpoint.checkpoint(
            fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        return torch.autograd.grad(out, leaves, do)

    ops.reset_counts()
    plain_run = grads(False)
    assert ops.dispatch_counts == {"flash_attention.kernel": 1}
    remat_run = grads(True)
    assert ops.dispatch_counts == {"flash_attention.kernel": 3}
    assert all(torch.equal(a, b) for a, b in zip(plain_run, remat_run))


@pytest.mark.cuda
def test_cuda_flash_attention_in_cuda_graph(dev):
    """Forward and backward captured into one CUDA graph (after an eager
    warm-up that compiles them) and replayed on new inputs copied into
    the captured ones: the eager bits each time."""
    shape = (2, 384, 4, 64)
    q, k, v, do = _flash_inputs(dev, shape, seed=3)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def body():
        out = ops.flash_attention(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, do))

    body()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = body()
    for seed in (4, 5):
        fresh = _flash_inputs(dev, shape, seed=seed)
        with torch.no_grad():
            for x, y in zip(leaves + [do], fresh):
                x.copy_(y)
        g.replay()
        torch.cuda.synchronize()
        want = body()
        assert all(torch.equal(a, b) for a, b in zip(captured, want))


@pytest.mark.cuda
def test_cuda_attend_takes_the_kernel_or_raises(dev):
    """``attend`` on CUDA tensors runs every causal self-attention through
    the kernel whatever ``attn_chunk`` (counted a call), and raises,
    without a fallback, on what the kernel does not take: a head dim
    above 256, a non-causal or a rectangular call, an unsupported dtype."""
    from repro_torch.models.layers import attention

    q, k, v, _ = _flash_inputs(dev, (1, 256, 2, 64), seed=6)
    ops.reset_counts()
    for chunk in (0, 64):
        out = attention.attend(q, k, v, causal=True, attn_chunk=chunk)
        assert torch.equal(out, ops.flash_attention(q, k, v))
    assert ops.dispatch_counts == {"flash_attention.kernel": 4}
    wide = torch.zeros((1, 16, 2, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        attention.attend(wide, wide, wide, causal=True)
    with pytest.raises(ValueError, match="causal"):
        attention.attend(q, k, v, causal=False)
    with pytest.raises(ValueError, match="causal"):
        attention.attend(q, k[:, :128], v[:, :128], causal=True)
    with pytest.raises(ValueError, match="dtype"):
        attention.attend(*(x.to(torch.float64) for x in (q, k, v)),
                         causal=True)
    assert ops.dispatch_counts == {"flash_attention.kernel": 4}

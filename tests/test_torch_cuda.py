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
    bit), f32 and bf16, on vector-aligned and unaligned rows."""
    for dtype in (torch.float32, torch.bfloat16):
        for chunk, num_chunks in ((1024, 37), (33, 20)):
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
            # A view at an odd element offset takes a narrower copy unit.
            view = x[1:1 + chunk * (num_chunks - 1)]
            assert torch.equal(t_cc.launch(view, idx[:3], chunk),
                               t_cc.plain(view, idx[:3], chunk))
            assert torch.equal(t_cl.launch(view, chunk),
                               t_cl.launch(view, chunk))
            torch.testing.assert_close(t_cl.launch(view, chunk),
                                       t_cl.plain(view, chunk), rtol=1e-6,
                                       atol=0)


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
    without them (the census sums in another order: rtol 1e-5)."""
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
    assert set(k_counts) == {"pool_pack.kernel", "pool_unpack_update.kernel",
                             "chunk_l1norm.kernel", "csc_compact.kernel"}
    assert k_counts["csc_compact.kernel"] == 3 and p_counts == {}
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    for a, b in zip(k_params, p_params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)

"""The flash-attention kernels' plain version (``kernels/flash_attention.py``)
on the CPU: its online-softmax forward (o and the log-sum-exp) and the
backward written from the log-sum-exp and D = rowsum(dO o), which the
kernels follow, against full attention's output and autograd gradients;
the checks on what the kernels take; the tile table; ``attend`` on CPU
tensors keeping the JAX-parity path (full or blockwise attention, the
same bits) while ``ops.flash_attention`` refuses them. The
kernels themselves run on the card (``test_torch_cuda.py``)."""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import attention

# f32: the plain version sums the same f32 products as full attention in
# key blocks of 64 with a running rescale, and takes the softmax through
# exp(s - lse) in the backward: the last bits differ (measured below
# 2e-6 at these sizes); rtol 1e-5, atol 1e-5 for entries near zero.
F32 = dict(rtol=1e-5, atol=1e-5)
# (b, s, h, hd): a whole block, a ragged length with a smoke config's 16-
# wide heads, 160-wide heads (stablelm-12b's) at a ragged length, 32 and
# 64 wide heads over several blocks.
SHAPES = [(2, 64, 2, 32), (2, 100, 3, 16), (1, 130, 2, 160),
          (2, 200, 2, 64), (1, 1, 2, 16)]


def _qkv(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _masked_scores(q, k):
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    return sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                          float("-inf"))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_forward_matches_full_attention(shape):
    q, k, v, _ = _qkv(shape)
    o, lse = fa.plain(q, k, v)
    assert o.shape == shape and o.is_contiguous()
    assert lse.shape == (shape[0], shape[2], shape[1])
    torch.testing.assert_close(
        o, attention.full_attention(q, k, v, causal=True), **F32)
    torch.testing.assert_close(
        lse, torch.logsumexp(_masked_scores(q, k), dim=-1), **F32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd(shape):
    """dq, dk, dv of the backward written from the log-sum-exp and D
    against autograd through full attention, for one cotangent."""
    q, k, v, do = _qkv(shape, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        attention.full_attention(*leaves, causal=True), leaves, do)
    o, lse = fa.plain(q, k, v)
    got = fa.plain_backward(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.shape == shape and g.is_contiguous()
        torch.testing.assert_close(g, w, **F32)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    through = torch.autograd.grad(fa.plain_attention(*leaves), leaves, do)
    for g, w in zip(through, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("block", [16, 48, 256])
def test_plain_key_blocks_do_not_change_the_function(block):
    """Another key block (the kernels' tiles differ from the plain
    version's 64) gives the same function to f32 rounding."""
    q, k, v, do = _qkv((2, 150, 2, 32), seed=2)
    o, lse = fa.plain(q, k, v)
    o_b, lse_b = fa.plain(q, k, v, block=block)
    torch.testing.assert_close(o_b, o, **F32)
    torch.testing.assert_close(lse_b, lse, **F32)
    for g, w in zip(fa.plain_backward(q, k, v, o, lse, do, block=block),
                    fa.plain_backward(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w, **F32)


def test_plain_bf16_meets_v_in_bf16():
    """bf16 inputs: o and the gradients come back in bf16, P meets V in
    bf16 (so o is not the f32 version's), and o stays within two bf16
    ulps of the largest |value| of full attention's (whose scores are
    rounded to bf16 before the f32 softmax)."""
    q, k, v, do = _qkv((2, 130, 2, 64), seed=3, dtype=torch.bfloat16)
    o, lse = fa.plain(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o32, _ = fa.plain(*(x.float() for x in (q, k, v)))
    assert not torch.equal(o.float(), o32)
    want = attention.full_attention(q, k, v, causal=True).float()
    assert (o.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()
    grads = fa.plain_backward(q, k, v, o, lse, do)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_attend_on_cpu_keeps_full_and_blockwise_attention():
    """On CPU tensors ``attend`` is the JAX-parity path, the same bits as
    ``full_attention`` (or ``blockwise_attention`` beyond ``attn_chunk``),
    and counts nothing; ``ops.flash_attention`` refuses CPU tensors, as
    the kernels do, before it counts."""
    q, k, v, _ = _qkv((2, 256, 2, 32), seed=4)
    ops.reset_counts()
    assert torch.equal(attention.attend(q, k, v, causal=True),
                       attention.full_attention(q, k, v, causal=True))
    assert torch.equal(
        attention.attend(q, k, v, causal=True, attn_chunk=64),
        attention.blockwise_attention(q, k, v, causal=True, chunk_q=64,
                                      chunk_k=64))
    assert torch.equal(attention.attend(q, k, v, causal=False),
                       attention.full_attention(q, k, v, causal=False))
    assert ops.dispatch_counts == {}
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v)
    assert ops.dispatch_counts == {}


@pytest.mark.parametrize("bad,match", [
    (dict(shape=(2, 8, 2, 512)), "head dims"),
    (dict(dtype=torch.float64), "dtype"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(k_len=4), "one shape"),
    (dict(shape=(2, 8, 2)), "one shape"),
    (dict(shape=(2, 0, 2, 16)), "non-empty"),
    (dict(shape=(4097, 8, 16, 16)), "batch x"),
    (dict(), "CUDA")])
def test_check_refuses_what_the_kernels_do_not_take(bad, match):
    """The kernels' checks, before any launch: CPU tensors are refused
    too (the kernels run on CUDA alone)."""
    shape = bad.get("shape", (2, 8, 2, 16))
    q = torch.zeros(shape, dtype=bad.get("dtype", torch.bfloat16))
    k = q[:, :bad["k_len"]] if "k_len" in bad else q
    with pytest.raises(ValueError, match=match):
        fa.check(q, k, q)


def test_tiles_cover_every_head_dim_and_line_up():
    """Every head dim 1..256 in bf16 and f32 has a plan; tiles are
    powers of two of at least 16 (the tensor cores' depth) and the
    diagonal's tiles line up (the forward's and dQ's query tile a
    multiple of their key tile, dK/dV's key tile a multiple of its query
    tile)."""
    assert [fa.padded_head_dim(d) for d in (1, 16, 17, 64, 100, 128, 160,
                                            256)] == [16, 16, 32, 64, 128,
                                                      128, 256, 256]
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        for dtype in fa.DTYPES:
            fa.plan_for(hd, dtype)
    for plan in fa.TILES.values():
        for t in plan:
            for x in (t.block_m, t.block_n):
                assert x >= 16 and x & (x - 1) == 0
            assert t.warps in (1, 2, 4, 8) and t.stages >= 1
        assert plan.fwd.block_m % plan.fwd.block_n == 0
        assert plan.dq.block_m % plan.dq.block_n == 0
        assert plan.dkdv.block_n % plan.dkdv.block_m == 0


def test_kernel_names_count_as_the_model():
    """The Triton source defines the four kernels the wrapper launches,
    and none of their names holds a word by which the benchmark's
    profile counts a kernel as the gradient pool's or the exchange's: the
    kernels count as the model's."""
    with open(fa.SOURCE) as f:
        src = f.read()
    names = re.findall(r"^def (flash_attn_\w+)\(", src, flags=re.M)
    assert names == ["flash_attn_fwd", "flash_attn_bwd_delta",
                     "flash_attn_bwd_dkdv", "flash_attn_bwd_dq"]
    for word in ("pool_pack", "pool_unpack", "chunk_l1norm", "csc_compact",
                 "fused_update", "nccl", "ring_kernel"):
        assert not any(word in n.lower() for n in names), word
    assert os.path.dirname(fa.SOURCE).endswith(os.path.join("kernels",
                                                            "csrc"))


def test_port_calls_no_library_attention():
    """No module of the port calls PyTorch's fused attention, cuDNN's
    attention or ``torch.compile``: attention on the card is the
    hand-written kernel (``chip_smoke.py`` times SDPA as a yardstick
    only)."""
    root = os.path.dirname(os.path.dirname(fa.__file__))
    found = []
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                with open(path) as f:
                    text = f.read()
                for word in ("scaled_dot_product_attention",
                             "torch.compile", "cudnn"):
                    if word in text:
                        found.append((os.path.relpath(path, root), word))
    assert found == []

"""Causal self-attention that never writes the S x S scores to device
memory: Triton kernels for Hopper, their ``torch.autograd.Function``, and
the plain PyTorch version they follow.

Replaces no Pallas kernel: the JAX package writes attention in ``jnp``
(``repro/models/layers/attention.py``), and so did the port
(``models/layers/attention.py``: ``full_attention`` builds the f32 score
matrix in six passes over device memory, 2.15 GB a layer at olmo-1b's
8 x 16 x 2048^2, about half of a training step). Added for that.

Bound on an H100: the tensor cores. The two forward products (QK^T, PV)
over the causal half take 2 S^2 hd FLOPs a head (the backward's five,
2.5 times that) against 8 S hd bytes of bf16 q, k, v and o: S / 4 FLOP
a byte, 512 at S = 2048, above the card's ~295 ridge. The design keeps
S and P in registers:

* ``flash_attn_fwd``: one program a (query tile, batch x head), the
  heaviest tiles (the last rows) first. It walks the key tiles ``j <= i``
  only, FlashAttention-2's recurrence: QK^T accumulates in f32 from the
  inputs' dtype, the scale is applied in f32 with log2(e) folded in for
  ``exp2``, the running max and sum stay f32, P is cast to the inputs'
  dtype to meet V (as ``full_attention`` casts it), the f32 accumulator
  is divided by the sum once at the end. Tiles wholly below the diagonal
  take no mask; the diagonal tiles mask inside. It writes o (b, s, h, hd)
  contiguous and the f32 log-sum-exp (b, h, s).
* ``flash_attn_bwd_delta``: D = rowsum(dO o) in f32.
* ``flash_attn_bwd_dkdv``: one program a (key tile, batch x head); it
  walks the query tiles at or below the diagonal, rebuilds P from the
  log-sum-exp and accumulates dK and dV in f32.
* ``flash_attn_bwd_dq``: one program a (query tile, batch x head) for dQ.

Sliding windows (``window`` W > 0: query i sees key j when 0 <= i - j <
W; afmoe's sliding layers): a ``WINDOW`` constexpr, 0 for full causal
attention, whose kernels are the causal ones unchanged. With a window the
forward and dQ start their key loop at the window's first tile and mask
the tiles the window's edge cuts; dK/dV stops its query loop at the last
query tile that sees the key tile. A window at least the sequence is no
window (the causal kernels run). ``window_ranges`` is the tile plan the
kernels compute, in Python, for the tests.

No atomics: every output element is written by one program, so a run
repeats bit for bit. q, k and v are read through their strides in the
(b, s, h, hd) layout; a head dim that is not a power of two is padded
with masked loads, a sequence that is not a multiple of a tile has its
last tile masked. Tiles are fixed a padded head dim and element size
(``TILES``), chosen by ``sweep --attention`` (PERF.md): no autotuning in
the timed process. The kernels' source, ``csrc/flash_attention_triton.py``,
imports Triton; ``_kernels`` loads it at the first launch, never at
import (machines without Triton import this module).

On float32 inputs the products run in full f32 (``input_precision=
"ieee"``), as PyTorch's f32 matmuls do on the card by default.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

LOG2E = 1.4426950408889634  # the kernels' exp2 takes log2(e) x the scale
MAX_HEAD_DIM = 256
DTYPES = (torch.bfloat16, torch.float32)  # the configurations' dtypes
MAX_GRID_Y = 65535  # batch x heads ride on the grid's second axis


class Tiles(NamedTuple):
    """One kernel's tile and launch: query rows, key rows, warps and
    software-pipeline stages."""
    block_m: int
    block_n: int
    warps: int
    stages: int


class Plan(NamedTuple):
    fwd: Tiles
    dkdv: Tiles
    dq: Tiles


# By (padded head dim, element bytes: bf16 2, f32 4). bf16 at 64 and 128
# (the benchmark's cells): the fastest of ``sweep --attention`` (PERF.md,
# PR 33); 16 and 32 take 64's; 256 and f32 (smoke runs, stablelm's 160)
# are cut to fit shared memory, untuned. The forward's and the dq
# kernel's block_m are multiples of their block_n, the dK/dV kernel's
# block_n a multiple of its block_m (the diagonal's tiles line up).
TILES: Dict[Tuple[int, int], Plan] = {
    (16, 2): Plan(Tiles(64, 64, 4, 3), Tiles(32, 128, 4, 4),
                  Tiles(64, 64, 4, 3)),
    (32, 2): Plan(Tiles(64, 64, 4, 3), Tiles(32, 128, 4, 4),
                  Tiles(64, 64, 4, 3)),
    (64, 2): Plan(Tiles(64, 64, 4, 3), Tiles(32, 128, 4, 4),
                  Tiles(64, 64, 4, 3)),
    (128, 2): Plan(Tiles(64, 64, 4, 3), Tiles(32, 64, 4, 4),
                   Tiles(128, 64, 8, 3)),
    (256, 2): Plan(Tiles(64, 32, 4, 2), Tiles(16, 64, 4, 2),
                   Tiles(64, 16, 4, 2)),
    (16, 4): Plan(Tiles(64, 32, 4, 2), Tiles(32, 64, 4, 2),
                  Tiles(64, 32, 4, 2)),
    (32, 4): Plan(Tiles(64, 32, 4, 2), Tiles(32, 64, 4, 2),
                  Tiles(64, 32, 4, 2)),
    (64, 4): Plan(Tiles(64, 32, 4, 2), Tiles(32, 64, 4, 2),
                  Tiles(64, 32, 4, 2)),
    (128, 4): Plan(Tiles(64, 32, 4, 2), Tiles(16, 64, 4, 2),
                   Tiles(64, 16, 4, 2)),
    (256, 4): Plan(Tiles(32, 16, 4, 1), Tiles(16, 32, 4, 1),
                   Tiles(32, 16, 4, 1)),
}
DELTA_ROWS = 64
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_triton.py"


def padded_head_dim(hd: int) -> int:
    """The power of two (at least 16, the tensor cores' depth) a head of
    ``hd`` is padded to."""
    return max(16, 1 << (hd - 1).bit_length())


def plan_for(hd: int, dtype: torch.dtype) -> Plan:
    """The tiles of a head of ``hd`` in ``dtype``."""
    return TILES[(padded_head_dim(hd), torch.finfo(dtype).bits // 8)]


def window_ranges(start: int, s: int, window: int, block_m: int,
                  block_n: int, key_tile: bool = False):
    """The kernels' loops as (lo, hi, mask) ranges of tile starts, mask
    'edge' (the window's), 'none' or 'diagonal' (causal, and the window's
    when there is one): the key tiles of the query tile at ``start``
    (forward, dQ), or with ``key_tile`` the query tiles of the key tile
    at ``start`` (dK/dV), whose query tiles are ``block_m`` rows and key
    tiles ``block_n``."""
    if key_tile:
        diag = (start, min(start + block_n, s), "diagonal")
        if not window:
            return [diag, (start + block_n, s, "none")]
        mid = max(start + block_n,
                  (max(start + window - block_m, 0) // block_m + 1)
                  * block_m)
        mid = min(mid, s)
        hi = min(s, start + block_n + window - 1)
        return [diag, (start + block_n, mid, "none"), (mid, hi, "edge")]
    diag = (start, min(start + block_m, s), "diagonal")
    if not window:
        return [(0, start, "none"), diag]
    lo = max(start - window + 1, 0) // block_n * block_n
    mid = -(-max(start + block_m - window, 0) // block_n) * block_n
    mid = min(max(mid, lo), start)
    return [(lo, mid, "edge"), (mid, start, "none"), diag]


def kernel_window(window: int, s: int) -> int:
    """The ``WINDOW`` the kernels take: 0 (full causal) for no window or
    one that reaches the whole sequence."""
    if window < 0:
        raise ValueError(f"a window is at least 1 (0: none), got {window}")
    return 0 if window >= s else window


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernels take (q, k, v): causal self-attention
    inputs of one shape (b, s, h, hd) and dtype (bf16 or f32), hd
    at most MAX_HEAD_DIM, b x h at most MAX_GRID_Y, all on one CUDA
    device."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention takes q, k, v of one shape (b, "
                         f"s, h, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes one dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, hd = q.shape
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes head dims 1..{MAX_HEAD_DIM},"
                         f" got {hd}")
    if b * h > MAX_GRID_Y or b * h == 0 or s == 0:
        raise ValueError(f"flash attention takes 1..{MAX_GRID_Y} batch x "
                         f"heads and a non-empty sequence, got b {b}, h "
                         f"{h}, s {s}")
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"the flash attention kernels run on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")


# -- the kernels ------------------------------------------------------------

_kernels_mod = None


def _kernels():
    """The Triton kernels' module, loaded (and Triton imported) at the
    first launch."""
    global _kernels_mod
    if _kernels_mod is None:
        spec = importlib.util.spec_from_file_location(
            "repro_torch_flash_attention_triton", SOURCE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _kernels_mod = mod
    return _kernels_mod


def _device(device: torch.device):
    """Make ``device`` current for Triton's launcher, which launches on
    the current device's current stream."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           plan: Optional[Plan] = None, window: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on q's device and current stream: (o (b, s, h,
    hd) contiguous in q's dtype, the f32 log-sum-exp (b, h, s) of the
    scaled scores). ``plan`` overrides ``TILES`` (the sweep's);
    ``window`` W > 0: sliding-window attention."""
    check(q, k, v)
    b, s, h, hd = q.shape
    window = kernel_window(window, s)
    t = (plan or plan_for(hd, q.dtype)).fwd
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kern = _kernels()
    with _device(q.device):
        kern.flash_attn_fwd[(_cdiv(s, t.block_m), b * h)](
            q, k, v, o, lse, *q.stride(), *k.stride(), *v.stride(), h, s,
            hd ** -0.5 * LOG2E, HD=hd, HD_P=padded_head_dim(hd),
            BLOCK_M=t.block_m, BLOCK_N=t.block_n,
            IEEE=q.dtype == torch.float32, WINDOW=window, num_warps=t.warps,
            num_stages=t.stages)
    return o, lse


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    plan: Optional[Plan] = None, window: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (D, then dK and dV, then dQ) on q's device
    and current stream: (dq, dk, dv), each (b, s, h, hd) contiguous in
    q's dtype. ``o`` and ``lse`` are ``launch``'s; ``do`` is read through
    its strides."""
    check(q, k, v)
    b, s, h, hd = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape \
            or not o.is_contiguous() or lse.shape != (b, h, s):
        raise ValueError(f"flash attention's backward takes o, do "
                         f"{tuple(q.shape)} {q.dtype} (o contiguous) and lse "
                         f"{(b, h, s)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)} {do.dtype}, {tuple(lse.shape)}")
    p = plan or plan_for(hd, q.dtype)
    hdp, ieee = padded_head_dim(hd), q.dtype == torch.float32
    window = kernel_window(window, s)
    scale = hd ** -0.5
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    strides = (*q.stride(), *k.stride(), *v.stride(), *do.stride())
    kern = _kernels()
    with _device(q.device):
        kern.flash_attn_bwd_delta[(_cdiv(s, DELTA_ROWS), b * h)](
            o, do, delta, *do.stride(), h, s, HD=hd, HD_P=hdp,
            BLOCK_M=DELTA_ROWS)
        t = p.dkdv
        kern.flash_attn_bwd_dkdv[(_cdiv(s, t.block_n), b * h)](
            q, k, v, do, lse, delta, dk, dv, *strides, h, s,
            scale * LOG2E, scale, HD=hd, HD_P=hdp, BLOCK_M=t.block_m,
            BLOCK_N=t.block_n, IEEE=ieee, WINDOW=window, num_warps=t.warps,
            num_stages=t.stages)
        t = p.dq
        kern.flash_attn_bwd_dq[(_cdiv(s, t.block_m), b * h)](
            q, k, v, do, lse, delta, dq, *strides, h, s, scale * LOG2E,
            scale, HD=hd, HD_P=hdp, BLOCK_M=t.block_m, BLOCK_N=t.block_n,
            IEEE=ieee, WINDOW=window, num_warps=t.warps, num_stages=t.stages)
    return dq, dk, dv


# -- the plain version ------------------------------------------------------


def _causal(q0: int, nq: int, k0: int, nk: int, device: torch.device,
            window: int = 0) -> torch.Tensor:
    d = (q0 + torch.arange(nq, device=device))[:, None] \
        - (k0 + torch.arange(nk, device=device))[None, :]
    return (d >= 0) & (d < window) if window else d >= 0


def _f32(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, hd) in any dtype -> (b, h, s, hd) f32: a product of
    these is the kernels' product of the inputs accumulated in f32."""
    return x.transpose(1, 2).float()


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          block: int = 64, window: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in the kernels' online-softmax form, in PyTorch ops on
    any device: each key block of ``block`` positions in turn, the scores
    (the inputs' product in f32) scaled in f32 and masked causally, the
    running max and sum in f32, P cast to q's dtype to meet V, the f32
    accumulator divided by the sum at the end; with a ``window``, a row
    that sees no key of a block yet keeps a zero sum. Returns (o (b, s, h,
    hd) in q's dtype, the f32 log-sum-exp (b, h, s))."""
    b, s, h, hd = q.shape
    window = kernel_window(window, s)
    scale = hd ** -0.5
    qf, kf, vf = _f32(q), _f32(k), _f32(v)
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, hd), device=q.device)
    for j in range(0, s, block):
        kj, vj = kf[:, :, j:j + block], vf[:, :, j:j + block]
        sc = (qf @ kj.transpose(-1, -2)) * scale
        sc = sc.masked_fill(~_causal(0, s, j, kj.shape[2], q.device,
                                     window), float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new) \
            if window else m_new
        p = torch.exp(sc - m_use[..., None])
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vj
        m = m_new
    o = (acc / l[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return o, m + torch.log(l)


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   block: int = 64, window: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward the kernels follow, in PyTorch ops: D = rowsum(dO o)
    in f32; for each key block, P rebuilt from the log-sum-exp, dV = P^T
    dO with P in the inputs' dtype, dS = P (dO V^T - D) in f32, dK = dS^T
    Q and dQ += dS K with dS in the inputs' dtype, the scale applied to
    dK and dQ at the end. Returns (dq, dk, dv) (b, s, h, hd) in q's
    dtype."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    window = kernel_window(window, s)
    qf, kf, vf, of, dof = (_f32(x) for x in (q, k, v, o, do))
    d = (dof * of).sum(dim=-1)
    dq = torch.zeros((b, h, s, hd), device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for j in range(0, s, block):
        kj, vj = kf[:, :, j:j + block], vf[:, :, j:j + block]
        sc = (qf @ kj.transpose(-1, -2)) * scale
        p = torch.exp(sc - lse[..., None]).masked_fill(
            ~_causal(0, s, j, kj.shape[2], q.device, window), 0.0)
        dv[:, :, j:j + block] = p.to(q.dtype).float().transpose(-1, -2) @ dof
        ds = p * (dof @ vj.transpose(-1, -2) - d[..., None])
        ds = ds.to(q.dtype).float()
        dk[:, :, j:j + block] = (ds.transpose(-1, -2) @ qf) * scale
        dq = dq + ds @ kj
    dq = dq * scale
    return tuple(x.to(q.dtype).transpose(1, 2).contiguous()
                 for x in (dq, dk, dv))


# -- autograd ---------------------------------------------------------------


class _Attention(torch.autograd.Function):
    """Causal self-attention whose backward rebuilds P from the forward's
    log-sum-exp: the kernels (``kernel`` True) or the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, kernel: bool, window: int):
        o, lse = launch(q, k, v, window=window) if kernel \
            else plain(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kernel, ctx.window = kernel, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        fn = launch_backward if ctx.kernel else plain_backward
        return (*fn(q, k, v, o, lse, do, window=ctx.window), None, None)


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Causal self-attention of (b, s, h, hd) q, k, v through the kernels,
    differentiable: o (b, s, h, hd) contiguous in q's dtype. ``window``
    W > 0: query i sees key j when 0 <= i - j < W."""
    return _Attention.apply(q, k, v, True, window)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """``kernel_attention``'s function through the plain version, on any
    device."""
    return _Attention.apply(q, k, v, False, window)

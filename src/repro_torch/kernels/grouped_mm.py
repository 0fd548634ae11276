"""Grouped matrix products over the experts one chip holds: Y = X W_e for
each expert e's rows of X, with its backward, as CUDA kernels for Hopper
(``csrc/grouped_mm.cu``), their ``torch.autograd.Function``, and the
plain PyTorch version they follow.

Replaces no Pallas kernel: the JAX package's MoE layer runs its experts
as one batched product over capacity-bounded buffers (``torch.bmm`` in
the port's softmax path). Added for afmoe's dropless routing (Trinity,
``models/layers/moe.py:apply_sigmoid``): a chip's slots are sorted by
expert, and each expert's rows, however many the routing sends, go
through its own weights with nothing dropped and no padding computed.
What bounds the kernels on an H100 (the tensor cores), their tiles, the
static grid that covers every routing, and why dW repeats bit for bit
are in the source's note:

* ``moe_gmm_fwd``: Y (R, N) from X (R, K) sorted by expert; the rows
  past the experts' (the slots routed to other chips) are written 0.
  dX = dY W_e^T is the same kernel reading W transposed.
* ``moe_gmm_dw``: dW_e = X_e^T dY_e, summed in f32 over the expert's
  rows; zeros for an expert without rows.

The operands are bf16 (the configurations' compute dtype), summed in
f32 and rounded once; K, N and the row strides are multiples of 8
elements and the bases 16-byte aligned (16-byte copies). ``launch`` and
``launch_dw`` always launch (or raise); ``plain`` and ``plain_dw`` are
the same functions in PyTorch ops on any device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

TILE_M = 128    # kTileM in the source: the row tiles of the forward
MAX_GRID_ROWS = 65535   # the forward's row tiles are its grid's y

_fns = {}


def _lib(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("grouped_mm"), name)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p] * 6 + [i64] * 6 + [i32, i32, i64, p]
                       if name == "moe_gmm_fwd_launch"
                       else [p] * 5 + [i64] * 4 + [i32, p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def layout(counts: torch.Tensor, block_m: int = TILE_M
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first row of each expert, its inclusive cumulative row tiles of
    ``block_m`` rows), int32 on counts' device, from the experts' row
    counts (E,)."""
    counts = counts.to(torch.int32)
    end = torch.cumsum(counts, 0, dtype=torch.int32)
    tiles = torch.cumsum((counts + block_m - 1) // block_m, 0,
                         dtype=torch.int32)
    return end - counts, tiles


def grid_rows(rows: int, experts: int, block_m: int = TILE_M) -> int:
    """Row tiles of the forward's static grid: every row on one expert,
    one partial tile at each expert's end, and the zero tiles after."""
    return -(-rows // block_m) + experts + 1


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def check(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> None:
    """Raise unless the kernels take x (R, K), w (E, K, N) bf16 with K
    and N multiples of 8, and counts (E,) integer, on one CUDA device."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or counts.shape != (w.shape[0],):
        raise ValueError(f"the grouped product takes x (R, K), w (E, K, N), "
                         f"counts (E,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(counts.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype \
            or counts.dtype.is_floating_point:
        raise ValueError(f"the grouped product's kernels take bf16 x and w "
                         f"and integer counts, got {x.dtype}, {w.dtype}, "
                         f"{counts.dtype}")
    if x.device.type != "cuda" or w.device != x.device \
            or counts.device != x.device:
        raise ValueError(f"the grouped product's kernels run on one CUDA "
                         f"device, got {x.device}, {w.device}, "
                         f"{counts.device}")
    if x.shape[1] % 8 or w.shape[2] % 8 or w.shape[0] == 0:
        raise ValueError(f"the grouped product's kernels take K and N "
                         f"multiples of 8 and at least one expert, got "
                         f"{tuple(w.shape)}")
    if grid_rows(x.shape[0], w.shape[0]) > MAX_GRID_ROWS:
        raise ValueError(f"{x.shape[0]} rows over {w.shape[0]} experts "
                         f"pass the forward's grid of {MAX_GRID_ROWS} row "
                         f"tiles")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t (R, C) with unit column stride, a row stride a multiple of 8 and
    a 16-byte aligned base (a copy when it has not)."""
    if t.stride(1) != 1 or t.stride(0) % 8 or not _aligned(t):
        t = t.contiguous()
    return t


def _b_layout(w: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(w, 1 when each w[e] is read transposed else 0, its line stride):
    unit stride along one of w's last two dims, the others multiples of
    8, a 16-byte aligned base (a contiguous copy when w has none)."""
    for trans, unit, line in ((0, 2, 1), (1, 1, 2)):
        if w.stride(unit) == 1 and w.stride(line) % 8 == 0 \
                and w.stride(0) % 8 == 0 and _aligned(w):
            return w, trans, w.stride(line)
    w = w.contiguous()
    return w, 0, w.stride(1)


# -- the kernels ------------------------------------------------------------


def launch(x: torch.Tensor, w: torch.Tensor,
           counts: torch.Tensor) -> torch.Tensor:
    """Y (R, N) contiguous bf16: row r of expert e (rows sorted by expert,
    ``counts`` (E,) of them each) times w[e]; rows past the experts' are
    0. ``w`` is read through its strides (a transposed view gives dY
    W^T)."""
    check(x, w, counts)
    (r, k), (e, _, n) = x.shape, w.shape
    x, (w, trans, ldb) = _rows(x), _b_layout(w)
    offs, tiles = layout(counts)
    counts = counts.to(torch.int32)
    y = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    err = build.call_on(
        x.get_device(), _lib("moe_gmm_fwd_launch"), x.data_ptr(),
        w.data_ptr(), y.data_ptr(), offs.data_ptr(), counts.data_ptr(),
        tiles.data_ptr(), r, k, n, x.stride(0), w.stride(0), ldb, trans, e,
        grid_rows(r, e))
    if err != 0:
        raise RuntimeError(f"moe_gmm_fwd kernel launch failed: CUDA error "
                           f"{err}")
    return y


def launch_dw(x: torch.Tensor, dy: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """dW (E, K, N) contiguous bf16: for each expert the sum of its rows'
    x^T dy, accumulated in f32; zeros for an expert without rows. ``dy``
    is read through its strides."""
    (r, k), n, e = x.shape, dy.shape[1], counts.shape[0]
    if dy.dim() != 2 or dy.shape[0] != r or dy.dtype != x.dtype \
            or dy.device != x.device or n % 8:
        raise ValueError(f"dW takes dy ({r}, N), N a multiple of 8, in "
                         f"{x.dtype} on {x.device}, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    check(x, x.new_empty((e, k, 0)), counts)  # x, counts, the device
    x, dy = _rows(x), _rows(dy)
    offs, _ = layout(counts)
    counts = counts.to(torch.int32)
    dw = torch.empty((e, k, n), dtype=x.dtype, device=x.device)
    err = build.call_on(
        x.get_device(), _lib("moe_gmm_dw_launch"), x.data_ptr(),
        dy.data_ptr(), dw.data_ptr(), offs.data_ptr(),
        counts.data_ptr(), k, n, x.stride(0), dy.stride(0), e)
    if err != 0:
        raise RuntimeError(f"moe_gmm_dw kernel launch failed: CUDA error "
                           f"{err}")
    return dw


# -- the plain version ------------------------------------------------------


def row_experts(counts: torch.Tensor, rows: int) -> torch.Tensor:
    """Each row's expert (E for the rows past the experts')."""
    end = torch.cumsum(counts.to(torch.int64), 0)
    return torch.searchsorted(end, torch.arange(rows, device=counts.device),
                              right=True)


def plain(x: torch.Tensor, w: torch.Tensor,
          counts: torch.Tensor) -> torch.Tensor:
    """``launch``'s function in PyTorch ops on any device: each expert's
    product in f32 over every row, kept on its own rows, rounded once to
    x's dtype."""
    owner = row_experts(counts, x.shape[0])[:, None]
    y = torch.zeros((x.shape[0], w.shape[2]), device=x.device)
    for e in range(w.shape[0]):
        y = torch.where(owner == e, x.float() @ w[e].float(), y)
    return y.to(x.dtype)


def plain_dw(x: torch.Tensor, dy: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """``launch_dw``'s function in PyTorch ops, in f32, rounded once."""
    owner = row_experts(counts, x.shape[0])[:, None]
    return torch.stack([
        (torch.where(owner == e, x.float(), 0.0).T @ dy.float())
        for e in range(counts.shape[0])]).to(x.dtype)


# -- autograd ---------------------------------------------------------------


class _GroupedMM(torch.autograd.Function):
    """Y = X W_e over each expert's rows; dX = dY W_e^T (the forward's
    kernel on W transposed), dW_e = X_e^T dY_e."""

    @staticmethod
    def forward(ctx, x, w, counts, kernel: bool):
        ctx.save_for_backward(x, w, counts)
        ctx.kernel = kernel
        return launch(x, w, counts) if kernel else plain(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        wt = w.transpose(1, 2)
        if ctx.kernel:
            dy = dy.to(x.dtype)
            return launch(dy, wt, counts), launch_dw(x, dy, counts), \
                None, None
        return plain(dy, wt, counts), plain_dw(x, dy, counts), None, None


def kernel_grouped_mm(x: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """x (R, K) sorted by expert, ``counts`` (E,) rows an expert, w (E, K,
    N) -> (R, N) through the kernels, differentiable in x and w."""
    return _GroupedMM.apply(x, w, counts, True)


def plain_grouped_mm(x: torch.Tensor, w: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """``kernel_grouped_mm``'s function through the plain version."""
    return _GroupedMM.apply(x, w, counts, False)

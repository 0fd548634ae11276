"""Gradient-pool pack: the CUDA kernel (``csrc/pool_pack.cu``), its
wrapper, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/pool_pack.py::pool_pack``
(body ``_kernel``): gather the 1-D leaves into the padded pool at their
static offsets, cast to the wire dtype, zero the padding, and optionally
take the per-chunk f32 L1 census of the wire values. With a wire-dtype
``out`` buffer the kernel writes into it — the port's form of the JAX
kernel's donated staging buffer (``input_output_aliases``).

Bound on an H100: bytes — each element is read once and written once
(6 B for f32 -> bf16), so 3.35 TB/s on the SXM card sets the floor. The
kernel's design for that bound is in the note at the top of the source.

``launch`` always launches the kernel (or raises); ``plain`` is the same
function in PyTorch ops. The dispatch between the two, and the launch
count, live in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.library("pool_pack")
    fn = lib.pool_pack_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segment_table(leaves: Sequence[torch.Tensor], offsets: Sequence[int],
                  sizes: Sequence[int], device: torch.device) -> torch.Tensor:
    """The device-side segment table the kernels read:
    int64 [leaf data pointers | pool offsets | sizes], copied
    asynchronously from pinned host memory (``build.to_device``: inside
    a CUDA graph capture, from the capture's host arena)."""
    rows = [t.data_ptr() for t in leaves] + list(offsets) + list(sizes)
    return build.to_device(torch.tensor(rows, dtype=torch.int64), device)


def check_segments(leaves: Sequence[torch.Tensor], offsets: Sequence[int],
                   sizes: Sequence[int], pool_size: int,
                   device: torch.device) -> None:
    """Raise unless the leaves are contiguous 1-D tensors on ``device``
    laid out back to back from offset 0 by the segment table, ending
    inside the pool. The kernels rely on it: an element below ``covered``
    belongs to the first segment that ends past it."""
    if not (len(leaves) == len(offsets) == len(sizes)):
        raise ValueError("leaves, offsets and sizes differ in length")
    end = 0
    for x, off, sz in zip(leaves, offsets, sizes):
        if x.device != device:
            raise ValueError(f"leaf on {x.device}, expected {device}")
        if x.dim() != 1 or not x.is_contiguous() or x.numel() != sz:
            raise ValueError(f"leaf must be contiguous 1-D of {sz} elements,"
                             f" got shape {tuple(x.shape)}")
        if off != end:
            raise ValueError(f"segment at {off} does not start where the "
                             f"previous one ends ({end}): the table must "
                             f"be gap-free from offset 0")
        end = off + sz
    if end > pool_size:
        raise ValueError(f"segments end at {end} past the pool {pool_size}")


def launch(leaves: Sequence[torch.Tensor], offsets: Sequence[int],
           sizes: Sequence[int], pool_size: int, chunk_elems: int,
           wire_dtype: torch.dtype, out: Optional[torch.Tensor] = None,
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the pack kernel on the leaves' CUDA device and current
    stream. Returns (wire pool, f32 norms or None); the pool is ``out``
    when given. Mixed-dtype leaves are promoted first, as the JAX kernel
    does."""
    if not leaves:
        raise ValueError("pool_pack needs at least one leaf")
    device = leaves[0].device
    if device.type != "cuda":
        raise ValueError(f"the pool_pack kernel runs on CUDA, got {device}")
    src = ref.result_dtype(leaves)
    if src not in DTYPE_CODES or wire_dtype not in DTYPE_CODES:
        raise TypeError(f"pool_pack kernel takes float32/bfloat16, got "
                        f"source {src}, wire {wire_dtype}")
    leaves = [x if x.dtype == src else x.to(src) for x in leaves]
    check_segments(leaves, offsets, sizes, pool_size, device)
    if chunk_elems and pool_size % chunk_elems:
        raise ValueError(f"pool {pool_size} is not a multiple of "
                         f"chunk_elems {chunk_elems}")
    if out is None:
        out = torch.empty((pool_size,), dtype=wire_dtype, device=device)
    elif (out.shape != (pool_size,) or out.dtype != wire_dtype
          or out.device != device or not out.is_contiguous()):
        raise ValueError(f"staging buffer must be contiguous "
                         f"{wire_dtype}[{pool_size}] on {device}, got "
                         f"{out.dtype}{list(out.shape)} on {out.device}")
    norms = torch.empty((pool_size // chunk_elems,), dtype=torch.float32,
                        device=device) if chunk_elems else None
    table = segment_table(leaves, offsets, sizes, device)
    covered = offsets[-1] + sizes[-1]
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(table.data_ptr(), len(leaves), covered, pool_size,
                 DTYPE_CODES[src], DTYPE_CODES[wire_dtype], out.data_ptr(),
                 norms.data_ptr() if norms is not None else None,
                 chunk_elems, stream)
    if err != 0:
        raise RuntimeError(f"pool_pack kernel launch failed: CUDA error "
                           f"{err}")
    return out, norms


def plain(leaves: Sequence[torch.Tensor], offsets: Sequence[int],
          sizes: Sequence[int], pool_size: int, chunk_elems: int,
          wire_dtype: torch.dtype, out: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in PyTorch ops, on any device: the same
    (pool, norms) as ``launch``, written into ``out`` when given."""
    return ref.pool_pack(leaves, offsets, pool_size, chunk_elems, wire_dtype,
                         out=out)

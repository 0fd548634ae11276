"""CSC chunk gather: the CUDA kernel (``csrc/csc_compact.cu``), its
wrapper, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/csc_compact.py::csc_compact``
(body ``_kernel``): ``wire[j] = pool_chunks[idx[j]]``, the k selected
chunks packed into the dense buffer CSC all-reduces (paper Fig 17).

Bound on an H100: bytes — each selected chunk is read and written once,
2 x k x 32,768 x 4 B for the f32 pool: 0.048 ms at k = 616 and 0.253 ms at
k = 3233 on 3.35 TB/s. The kernel's design for that bound is in the note
at the top of the source.

Indices are taken as ``select_chunks`` makes them (int64), so the main
path adds no cast. An index outside ``[0, C)`` traps the kernel, which
surfaces as a CUDA error at the next synchronisation; the wrapper does not
synchronise to check it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def _lib():
    fn = build.library("csc_compact").csc_compact_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, p, p]
        fn.restype = ctypes.c_int
    return fn


def launch(pool: torch.Tensor, idx: torch.Tensor,
           chunk_elems: int) -> torch.Tensor:
    """Launch the gather on the pool's CUDA device and current stream:
    pool (C*chunk,) of any dtype, idx (k,) -> (k*chunk,) of the pool's
    dtype."""
    device = pool.device
    if device.type != "cuda":
        raise ValueError(f"the csc_compact kernel runs on CUDA, got {device}")
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError(f"pool must be contiguous 1-D, got shape "
                         f"{tuple(pool.shape)}")
    n = pool.shape[0]
    if chunk_elems <= 0 or n == 0 or n % chunk_elems:
        raise ValueError(f"pool {n} is not a positive multiple of "
                         f"chunk_elems {chunk_elems}")
    if idx.dim() != 1 or idx.numel() == 0 or idx.device != device:
        raise ValueError(f"idx must be a non-empty 1-D tensor on {device}, "
                         f"got shape {tuple(idx.shape)} on {idx.device}")
    if idx.dtype != torch.int64:
        idx = idx.to(torch.int64)
    idx = idx.contiguous()
    k = idx.shape[0]
    out = torch.empty((k * chunk_elems,), dtype=pool.dtype, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(pool.data_ptr(), idx.data_ptr(), k, n // chunk_elems,
                 chunk_elems * pool.element_size(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"csc_compact kernel launch failed: CUDA error "
                           f"{err}")
    return out


def plain(pool: torch.Tensor, idx: torch.Tensor,
          chunk_elems: int) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    return ref.csc_compact(pool, idx, chunk_elems)

"""Per-chunk L1 census: the CUDA kernel (``csrc/chunk_l1norm.cu``), its
wrapper, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/chunk_l1norm.py::chunk_l1norm``
(body ``_kernel``): ``norms[c] = sum |pool[c*chunk:(c+1)*chunk]|`` in f32
over an f32 or bf16 pool. CSC takes it on the post-reduce pool every step
(the selection census of paper Fig 18).

Bound on an H100: bytes — each element is read once (4 B at f32), 538 MB
for the smollm-135m pool at 32,768-element chunks, 0.161 ms at 3.35 TB/s.
The kernel's design for that bound, and why its sum is deterministic, is
in the note at the top of the source.

``launch`` always launches the kernel (or raises); ``plain`` is the same
function in PyTorch ops. The dispatch between the two, and the launch
count, live in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pool_pack import DTYPE_CODES


def _lib():
    fn = build.library("chunk_l1norm").chunk_l1norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Launch the census kernel on the pool's CUDA device and current
    stream: (C*chunk,) f32 or bf16 -> f32[C]."""
    if pool.device.type != "cuda":
        raise ValueError(f"the chunk_l1norm kernel runs on CUDA, got "
                         f"{pool.device}")
    if pool.dtype not in DTYPE_CODES:
        raise TypeError(f"chunk_l1norm kernel takes float32/bfloat16, got "
                        f"{pool.dtype}")
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError(f"pool must be contiguous 1-D, got shape "
                         f"{tuple(pool.shape)}")
    n = pool.shape[0]
    if chunk_elems <= 0 or n == 0 or n % chunk_elems:
        raise ValueError(f"pool {n} is not a positive multiple of "
                         f"chunk_elems {chunk_elems}")
    norms = torch.empty((n // chunk_elems,), dtype=torch.float32,
                        device=pool.device)
    fn = _lib()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = fn(pool.data_ptr(), norms.shape[0], chunk_elems,
                 DTYPE_CODES[pool.dtype], norms.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"chunk_l1norm kernel launch failed: CUDA error "
                           f"{err}")
    return norms


def plain(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    return ref.chunk_l1norm(pool, chunk_elems)

"""CSC chunk gather: the CUDA kernel (``csrc/csc_compact.cu``), its
wrapper, its launch plan, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/csc_compact.py::csc_compact``
(body ``_kernel``): ``wire[j] = pool_chunks[idx[j]]``, the k selected
chunks packed into the dense buffer CSC all-reduces (paper Fig 17).

Bound on an H100: bytes — each selected chunk is read and written once,
2 x k x 32,768 x 4 B for the f32 pool: 0.048 ms at k = 616 and 0.253 ms at
k = 3233 on 3.35 TB/s. The kernel's design for that bound is in the note
at the top of the source. ``plan`` picks its path (``bulk``: a persistent
grid of TMA bulk copies, for rows of a multiple of 16 bytes on 16-byte
aligned bases; ``vector`` or ``element``: a block a (row, slice), copying
in the widest unit the addresses allow) and its grid; ``schedule`` lists
the byte ranges each CTA copies, in the kernel's order.

Indices are taken as ``select_chunks`` makes them (int64), so the main
path adds no cast. An index outside ``[0, C)`` traps the kernel, which
surfaces as a CUDA error at the next synchronisation; the wrapper does not
synchronise to check it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

STAGE_BYTES = 16384     # a piece: the most one stage holds
STAGES = 12             # S: S - 1 loads in flight a CTA, a store behind
CTAS_PER_SM = 1         # S x 16 KiB of shared memory each
THREADS = 256           # the vector path's block (kThreads)
UNITS_PER_THREAD = 8    # the vector path's units a thread (kUnitsPerThread)
MAX_SLICES = 65535      # the vector path's grid.y cap (kMaxSlices)
SMEM_LIMIT = 232_448    # shared memory a Hopper block can use
PATH_CODES = {"bulk": 0, "vector": 1, "element": 1}

_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = build.library("csc_compact").csc_compact_launch
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def plan(k: int, num_chunks: int, row_bytes: int, itemsize: int,
         base_align: int, sms: int, grid: Optional[int] = None) -> Dict:
    """The launch of one gather (pure arithmetic). ``base_align`` is the
    largest power of two up to 16 dividing both the pool's and the
    output's address; ``sms`` the card's SM count. Returns ``path``, ``unit_bytes`` (the copy unit),
    ``grid`` (the bulk path's CTAs; the vector path's slices a row, its
    grid being (k, slices)), ``ctas``, ``stage_bytes``, ``stages``,
    ``pieces`` (a row's), ``items`` (k x pieces) and ``smem_bytes``.
    ``grid`` overrides the plan's."""
    unit = build.base_align(base_align, row_bytes)
    if unit == 16:
        stage = min(STAGE_BYTES, row_bytes)
        pieces = -(-row_bytes // stage)
        items = k * pieces
        g = min(items, sms * CTAS_PER_SM) if grid is None else grid
        if not 1 <= g <= items:
            raise ValueError(f"grid {g} outside [1, {items}]")
        return {"k": k, "num_chunks": num_chunks, "row_bytes": row_bytes,
                "path": "bulk", "unit_bytes": 16, "grid": g, "ctas": g,
                "stage_bytes": stage, "stages": STAGES, "pieces": pieces,
                "items": items, "smem_bytes": STAGES * (stage + 8)}
    span = THREADS * UNITS_PER_THREAD * unit
    slices = min(-(-row_bytes // span), MAX_SLICES) if grid is None else grid
    if not 1 <= slices <= MAX_SLICES:
        raise ValueError(f"grid {slices} outside [1, {MAX_SLICES}]")
    return {"k": k, "num_chunks": num_chunks, "row_bytes": row_bytes,
            "path": "vector" if unit > itemsize else "element",
            "unit_bytes": unit, "grid": slices, "ctas": k * slices,
            "stage_bytes": 0, "stages": 0, "pieces": slices,
            "items": k * slices, "smem_bytes": 0}


def schedule(p: Dict, row_bytes: int) -> Iterator[Tuple[int, int, int, int]]:
    """(cta, output row, first byte, end byte) for every copy of the plan,
    each CTA's in its order: on the bulk path the items b, b + grid, ...
    of CTA b, item = row * pieces + piece; on the vector path block
    (row, y) copies spans y, y + slices, ... of its row."""
    if p["path"] == "bulk":
        stage, pieces, grid = p["stage_bytes"], p["pieces"], p["grid"]
        for cta in range(grid):
            for item in range(cta, p["items"], grid):
                row, lo = divmod(item, pieces)
                lo *= stage
                yield cta, row, lo, min(lo + stage, row_bytes)
        return
    span = THREADS * UNITS_PER_THREAD * p["unit_bytes"]
    slices = p["grid"]
    for row in range(p["ctas"] // slices):
        for y in range(slices):
            for lo in range(y * span, row_bytes, slices * span):
                yield row * slices + y, row, lo, min(lo + span, row_bytes)


@functools.lru_cache(maxsize=None)
def launch_words(*plan_args) -> ctypes.Array:
    """``plan(*plan_args)`` as the C launcher reads it: {k, num_chunks,
    row_bytes, path, unit_bytes, grid, stage_bytes, stages}."""
    p = plan(*plan_args)
    return build.words([p["k"], p["num_chunks"], p["row_bytes"],
                        PATH_CODES[p["path"]], p["unit_bytes"], p["grid"],
                        p["stage_bytes"], p["stages"]])


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(pool: torch.Tensor, idx: torch.Tensor, chunk_elems: int,
           grid: Optional[int] = None) -> torch.Tensor:
    """Launch the gather on the pool's CUDA device and current stream:
    pool (C*chunk,) of any dtype, idx (k,) -> (k*chunk,) of the pool's
    dtype. ``grid`` overrides the plan's grid. Kept lean: its host time is
    on the path's critical path when the device is idle."""
    if not pool.is_cuda:
        raise ValueError(f"the csc_compact kernel runs on CUDA, got "
                         f"{pool.device}")
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError(f"pool must be contiguous 1-D, got shape "
                         f"{tuple(pool.shape)}")
    n = pool.shape[0]
    if chunk_elems <= 0 or n == 0 or n % chunk_elems:
        raise ValueError(f"pool {n} is not a positive multiple of "
                         f"chunk_elems {chunk_elems}")
    device = pool.get_device()
    if idx.dim() != 1 or idx.numel() == 0 or idx.get_device() != device:
        raise ValueError(f"idx must be a non-empty 1-D tensor on "
                         f"{pool.device}, got shape {tuple(idx.shape)} on "
                         f"{idx.device}")
    if idx.dtype != torch.int64:
        idx = idx.to(torch.int64)
    idx = idx.contiguous()
    k = idx.shape[0]
    out = pool.new_empty(k * chunk_elems)
    size = pool.element_size()
    src, dst = pool.data_ptr(), out.data_ptr()
    words = launch_words(k, n // chunk_elems, chunk_elems * size, size,
                         build.base_align(src, dst), _sms(device), grid)
    err = build.call_on(device, _lib(), src, idx.data_ptr(), dst, words)
    if err != 0:
        raise RuntimeError(f"csc_compact kernel launch failed: CUDA error "
                           f"{err}")
    return out


def plain(pool: torch.Tensor, idx: torch.Tensor,
          chunk_elems: int) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    return ref.csc_compact(pool, idx, chunk_elems)

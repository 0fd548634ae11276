"""Per-chunk L1 census: the CUDA kernel (``csrc/chunk_l1norm.cu``), its
wrapper, its launch plan, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/chunk_l1norm.py::chunk_l1norm``
(body ``_kernel``): ``norms[c] = sum |pool[c*chunk:(c+1)*chunk]|`` in f32
over an f32 or bf16 pool. CSC takes it on the post-reduce pool every step
(the selection census of paper Fig 18).

Bound on an H100: bytes — each element is read once (4 B at f32), 538 MB
for the smollm-135m pool at 32,768-element chunks, 0.161 ms at 3.35 TB/s.
The kernel's design for that bound, and why its sum is deterministic, is
in the note at the top of the source. ``plan`` picks its path (``bulk``:
a persistent grid fed by TMA bulk loads, f32 rows of a multiple of 16
bytes on a 16-byte aligned base; ``vector`` or ``element``: one block a
chunk, for bf16 and unaligned rows) and its grid; ``census_order`` is the
bulk path's summation order in numpy.

``launch`` always launches the kernel (or raises); ``plain`` is the same
function in PyTorch ops. The dispatch between the two, and the launch
count, live in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pool_pack import DTYPE_CODES

STAGE_BYTES = 32768     # kStageBytes in the source: a piece of a chunk
CONSUMERS = 256         # kConsumers in the source: threads that sum
STAGES = 6              # S: bulk loads a CTA keeps in flight
CTAS_PER_SM = 1         # S x 32 KiB of shared memory each
MAX_BLOCKS = 1 << 20    # the block path's grid cap (kMaxBlocks)
SMEM_LIMIT = 232_448    # shared memory a Hopper block can use
PATH_CODES = {"bulk": 0, "vector": 1, "element": 2}

_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = build.library("chunk_l1norm").chunk_l1norm_launch
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def plan(num_chunks: int, chunk_elems: int, itemsize: int, base_align: int,
         sms: int, grid: Optional[int] = None) -> Dict:
    """The launch of one census (pure arithmetic): ``path``, ``grid``
    (CTAs; CTA b sums chunks b, b + grid, ...), ``stage_bytes``,
    ``stages``, ``pieces`` (stages a chunk) and ``smem_bytes`` (dynamic
    shared memory a CTA). ``base_align`` is the largest power of two up to
    16 dividing the pool's address; ``sms`` the card's SM count. ``grid``
    overrides the grid (at most one CTA a chunk); the norms do not depend
    on it."""
    chunk_bytes = chunk_elems * itemsize
    aligned = base_align % 16 == 0 and chunk_bytes % 16 == 0
    if aligned and itemsize == 4:
        path, cap = "bulk", sms * CTAS_PER_SM
    else:
        path, cap = ("vector" if aligned else "element"), MAX_BLOCKS
    g = min(num_chunks, cap) if grid is None else grid
    if not 1 <= g <= num_chunks:
        raise ValueError(f"grid {g} outside [1, {num_chunks}]")
    bulk = path == "bulk"
    return {"num_chunks": num_chunks, "chunk_elems": chunk_elems,
            "itemsize": itemsize, "path": path, "grid": g,
            "stage_bytes": STAGE_BYTES if bulk else 0,
            "stages": STAGES if bulk else 0,
            "pieces": -(-chunk_bytes // STAGE_BYTES) if bulk else 1,
            "smem_bytes": STAGES * (STAGE_BYTES + 16) if bulk else 0}


def census_order(pool: np.ndarray, chunk_elems: int) -> np.ndarray:
    """The bulk path's norms, bit for bit, in numpy: vector g of a chunk
    (4 f32) summed as ((|x0|+|x1|)+|x2|)+|x3| and added by thread
    g % CONSUMERS in increasing g, a butterfly of shuffles in each warp,
    then the warps' sums in warp order. Nothing in it depends on the grid.
    """
    x = np.abs(np.asarray(pool, np.float32).reshape(-1, chunk_elems))
    assert chunk_elems % 4 == 0, chunk_elems
    v = x.reshape(x.shape[0], -1, 4)
    vec = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
    rounds = -(-vec.shape[1] // CONSUMERS)
    pad = np.zeros((vec.shape[0], rounds * CONSUMERS), np.float32)
    pad[:, :vec.shape[1]] = vec  # + 0.0 leaves a non-negative sum as it is
    per = pad.reshape(vec.shape[0], rounds, CONSUMERS)
    acc = np.zeros((vec.shape[0], CONSUMERS), np.float32)
    for r in range(rounds):
        acc = acc + per[:, r]
    warps = acc.reshape(vec.shape[0], CONSUMERS // 32, 32)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        warps = warps + warps[..., lanes ^ off]
    total = np.zeros(vec.shape[0], np.float32)
    for w in range(CONSUMERS // 32):
        total = total + warps[:, w, 0]
    return total


@functools.lru_cache(maxsize=None)
def launch_words(*plan_args) -> ctypes.Array:
    """``plan(*plan_args)`` as the C launcher reads it: {num_chunks,
    chunk_elems, dtype code, path, grid, stage_bytes, stages}."""
    p = plan(*plan_args)
    return build.words([p["num_chunks"], p["chunk_elems"],
                        0 if p["itemsize"] == 4 else 1, PATH_CODES[p["path"]],
                        p["grid"], p["stage_bytes"], p["stages"]])


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(pool: torch.Tensor, chunk_elems: int,
           grid: Optional[int] = None) -> torch.Tensor:
    """Launch the census kernel on the pool's CUDA device and current
    stream: (C*chunk,) f32 or bf16 -> f32[C]. ``grid`` overrides the
    plan's grid (the norms are the same bits at any grid). Kept lean: its
    host time is on the path's critical path when the device is idle."""
    if not pool.is_cuda:
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
    num_chunks = n // chunk_elems
    device = pool.get_device()
    norms = pool.new_empty(num_chunks, dtype=torch.float32)
    src = pool.data_ptr()
    words = launch_words(num_chunks, chunk_elems, pool.element_size(),
                         build.base_align(src), _sms(device), grid)
    err = build.call_on(device, _lib(), src, norms.data_ptr(), words)
    if err != 0:
        raise RuntimeError(f"chunk_l1norm kernel launch failed: CUDA error "
                           f"{err}")
    return norms


def plain(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    return ref.chunk_l1norm(pool, chunk_elems)

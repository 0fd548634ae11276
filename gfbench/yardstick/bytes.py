"""Device-memory and link bytes of the backend's kernels, a frozen copy
of the arithmetic behind the kernels' bounds (``chip_smoke.py``,
``kernels/ring_reduce.py``'s ``bound_bytes``): each input byte read
once and each output byte written once, whatever a kernel reads again.

The gradient pool holds every weight's gradient, contiguous, padded at
its end to a multiple of the CSC chunk (CSC and the low-bit wires) or
not at all.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence


def pool_elems(shapes: Dict[str, Sequence[int]], pad_to: int = 1) -> int:
    """The pool's elements: every weight, padded to ``pad_to``."""
    n = sum(math.prod(s) for s in shapes.values())
    return -(-n // pad_to) * pad_to


def sent_elems(shapes: Dict[str, Sequence[int]], gf: Dict) -> int:
    """Elements a step's all-reduces sum: the whole pool, or under CSC
    its k = round((1 - sparsity) C) kept chunks of the C in the pool."""
    if gf["mode"] != "csc":
        return pool_elems(shapes)
    chunk = gf["chunk_elems"]
    c = pool_elems(shapes, chunk) // chunk
    return min(max(int(round((1.0 - gf["sparsity"]) * c)), 1), c) * chunk


def unpack_update_bytes(leaf_elems: int, pool: int) -> int:
    """One step's pool unpack + momentum-SGD update over the whole pool:
    reads of the f32 master, the f32 reduced gradient and the f32
    momentum and the 1-byte mask over the (padded) pool, the write of the
    momentum over the pool and of each f32 leaf over the weights: 17 B a
    pool element and 4 B a weight."""
    return 17 * pool + 4 * leaf_elems


def pack_bytes(leaf_elems: int, pool: int, out_itemsize: int) -> int:
    """One pack: the f32 leaves read once, the pool written once in its
    dtype."""
    return 4 * leaf_elems + out_itemsize * pool


def ring_hbm_bytes(n_elems: int, n_ranks: int, wire_itemsize: int,
                   src_itemsize: int) -> int:
    """Device-memory bytes one rank's ring all-reduce of ``n_elems`` must
    move: x read and the output written, and on each of the 2(N-1)
    exchange steps one segment of ceil(n/N) written into the neighbour's
    slots and one read out of its own, in the wire dtype."""
    if n_ranks < 2 or not n_elems:
        return 0
    seg = -(-n_elems // n_ranks)
    return 2 * n_elems * src_itemsize \
        + 2 * (n_ranks - 1) * seg * 2 * wire_itemsize


def ring_link_bytes(n_elems: int, n_ranks: int, wire_itemsize: int) -> float:
    """Bytes one rank sends over its link in an all-reduce of
    ``n_elems``, whatever implements it: 2(N-1)/N of the message."""
    if n_ranks < 2:
        return 0.0
    return 2 * (n_ranks - 1) / n_ranks * n_elems * wire_itemsize

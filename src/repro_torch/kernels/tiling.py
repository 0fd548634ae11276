"""Static tile schedule over the pool's segment table.

The port's own copy of the JAX package's ``tile_schedule``: it intersects
every leaf segment with every tile it touches and lists one copy per
(segment, tile) pair, plus zero fills for the padding tail. Pure Python;
the tests hold it against the JAX schedule, and it is the reference for
how the CUDA kernels split a pool into block tiles (each block finds its
tile's first segment by binary search instead of reading this list).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TileCopy:
    """One copy between a leaf segment and a tile-local range. ``leaf``
    indexes the segment table (-1 for a zero fill), ``src_lo`` is the
    offset inside the leaf, ``dst_lo`` the offset inside tile ``tile``."""

    leaf: int
    tile: int
    src_lo: int
    dst_lo: int
    elems: int


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A pool's static schedule: tiling plus the copy list."""

    pool_size: int
    tile_elems: int
    num_tiles: int
    copies: Tuple[TileCopy, ...]
    fills: Tuple[TileCopy, ...]

    @property
    def num_copies(self) -> int:
        return len(self.copies)


@functools.lru_cache(maxsize=64)
def tile_schedule(offsets: Tuple[int, ...], sizes: Tuple[int, ...],
                  pool_size: int, tile_elems: int) -> TilePlan:
    """Intersect every segment with the tiles it spans."""
    assert len(offsets) == len(sizes)
    assert 0 < tile_elems
    num_tiles = -(-pool_size // tile_elems)
    copies = []
    for leaf, (off, sz) in enumerate(zip(offsets, sizes)):
        if sz == 0:
            continue
        assert off + sz <= pool_size, (off, sz, pool_size)
        for tile in range(off // tile_elems, (off + sz - 1) // tile_elems + 1):
            lo = max(off, tile * tile_elems)
            hi = min(off + sz, (tile + 1) * tile_elems)
            copies.append(TileCopy(leaf=leaf, tile=tile, src_lo=lo - off,
                                   dst_lo=lo - tile * tile_elems,
                                   elems=hi - lo))
    covered = (offsets[-1] + sizes[-1]) if sizes else 0
    fills = []
    if covered < pool_size:
        for tile in range(covered // tile_elems, num_tiles):
            lo = max(covered, tile * tile_elems)
            hi = min(pool_size, (tile + 1) * tile_elems)
            fills.append(TileCopy(leaf=-1, tile=tile, src_lo=0,
                                  dst_lo=lo - tile * tile_elems,
                                  elems=hi - lo))
    return TilePlan(pool_size=pool_size, tile_elems=tile_elems,
                    num_tiles=num_tiles, copies=tuple(copies),
                    fills=tuple(fills))

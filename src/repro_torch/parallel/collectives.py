"""Data-parallel reductions over ``torch.distributed``.

The JAX package sums over named mesh axes inside ``shard_map``. The port
sums over the default process group: an all-reduce when one is
initialised, the identity when none is — exactly what a psum over a
size-1 axis gives. The group is the caller's to create
(``torch.distributed.init_process_group`` with an explicit address, world
size and rank).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def data_world_size() -> int:
    """Number of data-parallel shards: the default group's size, or 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def all_reduce_sum(x: torch.Tensor, *, async_op: bool = False
                   ) -> Tuple[torch.Tensor, Optional[object]]:
    """Sum ``x`` in place across the default group.

    Returns ``(x, work)``: ``work`` is the async handle to ``wait()`` on
    when ``async_op`` is set and a group exists, else None (the sum is
    complete on return, or there was nothing to sum)."""
    if not (dist.is_available() and dist.is_initialized()):
        return x, None
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, async_op=async_op)
    return x, (work if async_op else None)


def reduce_pool(x: torch.Tensor, algo=None) -> torch.Tensor:
    """Sum ``x`` across the data-parallel group (synchronously, in place).
    ``algo`` is a ``topology`` algorithm object; None means flat."""
    if algo is None:
        return all_reduce_sum(x)[0]
    out, work = algo.reduce(x)
    return out

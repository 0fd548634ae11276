"""Lazy allreduce (paper §3.1), in PyTorch.

The contiguous gradient pool is reduced in θ-element buckets that close
at tensor boundaries — one all-reduce per bucket. ``issue_bucket`` starts
one bucket's all-reduce (asynchronously when a process group exists) and
returns a handle whose ``wait()`` gives the summed segment in f32; the
overlap engine issues bucket *i* before it emits bucket *i-1*'s update,
and the monolithic path (``bucketed_reduce``) issues every bucket, then
joins the sums.

The all-reduce runs in place on the pool's slice: the wire pool is dead
after its reduce (the next step packs it anew), so no copy is made. The
algorithm of a bucket comes from the topology layer; ``topo`` is the
topology its groups are drawn from (None: the default group).

A low-bit float wire (fp8-e4m3, ``core.wire``) is upcast to the f32
accumulator before every algorithm but ``pallas_ring``: a library sum in
fp8 would round at every add (and gloo has no fp8). The sum of the
upcast words is the exact sum the ring's per-hop rounding is held
against. int8 words ride every algorithm as they are: the rank clip
keeps every partial sum on the grid, so any order sums them exactly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel.topology import FLAT
from repro_torch.runtime import trace

AlgoSpec = Union[None, object, Sequence[object]]


def _algo_for(algo: AlgoSpec, i: int):
    if algo is None or hasattr(algo, "reduce"):
        return algo
    return algo[i]


class PendingBucket:
    """One issued bucket all-reduce."""

    def __init__(self, seg: torch.Tensor, work, accum_dtype: torch.dtype):
        self._seg = seg
        self._work = work
        self._accum = accum_dtype

    def wait(self) -> torch.Tensor:
        """Block the stream on the collective; the summed segment in the
        accumulator dtype."""
        with trace.span("gf.wait"):
            if self._work is not None:
                self._work.wait()
                self._work = None
            return self._seg.to(self._accum)


def issue_bucket(pool: torch.Tensor, start: int, end: int,
                 wire_dtype: Optional[torch.dtype], *, algo=None, topo=None,
                 accum_dtype: torch.dtype = torch.float32) -> PendingBucket:
    """Start ONE bucket's collective: slice [start, end) off the pool,
    cast to the wire dtype (None = the pool is already wire-packed), and
    sum it across the data-parallel group."""
    with trace.span("gf.issue"):
        seg = pool[start:end]
        if wire_dtype is not None and seg.dtype != wire_dtype:
            seg = seg.to(wire_dtype)
        if (seg.dtype.is_floating_point and seg.element_size() == 1
                and getattr(algo, "name", "flat") != "pallas_ring"):
            seg = seg.to(accum_dtype)
        seg, work = (algo or FLAT).reduce(seg, topo, async_op=True)
    return PendingBucket(seg, work, accum_dtype)


def reduce_bucket(pool: torch.Tensor, start: int, end: int,
                  wire_dtype: Optional[torch.dtype], *, algo=None, topo=None,
                  accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One bucket's summed segment in ``accum_dtype`` (synchronous)."""
    return issue_bucket(pool, start, end, wire_dtype, algo=algo, topo=topo,
                        accum_dtype=accum_dtype).wait()


def bucketed_reduce_parts(pool: torch.Tensor,
                          boundaries: Sequence[Tuple[int, int]],
                          wire_dtype: Optional[torch.dtype], *,
                          algo: AlgoSpec = None, topo=None,
                          accum_dtype: torch.dtype = torch.float32,
                          ) -> List[torch.Tensor]:
    """One summed segment per boundary. Every bucket is issued before the
    first is waited on, so the collectives queue back to back."""
    pending = [issue_bucket(pool, s, e, wire_dtype, algo=_algo_for(algo, i),
                            topo=topo, accum_dtype=accum_dtype)
               for i, (s, e) in enumerate(boundaries)]
    return [p.wait() for p in pending]


def bucketed_reduce(pool: torch.Tensor,
                    boundaries: Sequence[Tuple[int, int]],
                    wire_dtype: Optional[torch.dtype], *,
                    algo: AlgoSpec = None, topo=None,
                    accum_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """The summed pool in ``accum_dtype``, one collective per boundary
    (``bucketed_reduce_parts`` joined): what the monolithic path reduces.
    The caller divides by the group size."""
    parts = bucketed_reduce_parts(pool, boundaries, wire_dtype, algo=algo,
                                  topo=topo, accum_dtype=accum_dtype)
    return parts[0] if len(parts) == 1 else torch.cat(parts)

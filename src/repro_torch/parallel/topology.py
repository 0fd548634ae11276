"""Collective algorithm selection — the part of the JAX package's
``parallel/topology.py`` that the port's main path needs.

``Topology`` here is the level stack without fabric constants (the cost
model is not ported). ``resolve_algorithm`` returns the flat all-reduce for
``'flat'`` and for ``'auto'`` on a topology of fewer than two levels — the
same result the JAX package gives there. Every other algorithm raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Level:
    """One reduction level: the axis name and its degree."""

    axis: str
    size: int


@dataclasses.dataclass(frozen=True)
class Topology:
    """An ordered stack of levels, slowest first."""

    levels: Tuple[Level, ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(lv.axis for lv in self.levels)

    @property
    def num_devices(self) -> int:
        n = 1
        for lv in self.levels:
            n *= lv.size
        return n

    @staticmethod
    def flat(axis: str, size: int) -> "Topology":
        return Topology(levels=(Level(axis, size),))


@dataclasses.dataclass(frozen=True)
class FlatAllReduce:
    """One all-reduce over the data-parallel group (the flat ring psum of
    the JAX package; NCCL picks its own ring or tree on the card)."""

    name: str = "flat"

    def reduce(self, x, *, async_op: bool = False):
        return collectives.all_reduce_sum(x, async_op=async_op)


FLAT = FlatAllReduce()

_NOT_PORTED = ("two_level", "tree", "pallas_ring")


def resolve_algorithm(collective_algo: str, topo: Optional[Topology],
                      msg_bytes: float = 0.0) -> FlatAllReduce:
    """Config string -> algorithm object (GradientFlow's entry point)."""
    if collective_algo == "flat":
        return FLAT
    if collective_algo == "auto":
        if topo is None or len(topo.levels) < 2:
            return FLAT
        raise NotImplementedError(
            "collective_algo='auto' on a multi-level topology needs the "
            "cost model, which repro_torch has not ported yet; see "
            "ROADMAP.md queue A")
    if collective_algo in _NOT_PORTED:
        raise NotImplementedError(
            f"collective_algo={collective_algo!r} is not ported to "
            "repro_torch yet; see ROADMAP.md queue A")
    raise ValueError(f"unknown collective_algo {collective_algo!r}; "
                     f"known: ['auto', 'flat', {', '.join(map(repr, _NOT_PORTED))}]")

"""Data-parallel reductions over ``torch.distributed``.

The JAX package sums over named mesh axes inside ``shard_map``. The port
sums over process groups: the default group for the flat all-reduce, and
one subgroup per topology level (``level_groups``) for the two-level, tree
and ring algorithms. With no process group initialised every reduction is
the identity — exactly what a psum over a size-1 axis gives. The default
group is the caller's to create (``torch.distributed.init_process_group``
with an explicit address, world size and rank).

A mesh with a model axis (``launch.mesh.make_mesh``) registers its data
group here (``set_data_group``), with the ranks of every model index's
data group: the data-parallel reductions then run over that group,
``data_world_size`` is its size, a one-level topology's level group is
that group, and a topology of more levels (the ('pod', 'data') mesh's
two) is laid over the data group's ranks in their order. Without one,
the data group is the default group, as before.

Ranks map onto a topology's levels (slowest first) in row-major order:
``index = Σ coord_l · stride_l``, the index a rank's place in the data
group (its global rank without a model axis). ``level_groups`` creates,
once per topology shape and on every rank in one order, a group per
level and per coordinate of the other levels, and a group per innermost
coordinate over all outer levels (the two-level algorithm's middle
phase); under a model axis it does so inside each model index's data
group in turn, so every rank creates every group, its own or not
(``dist.new_group`` is collective over the world).

Each collective of the data group runs in a ``comm.all_reduce`` span
and, when the group has more than one rank, is counted once where it is
entered (``all_reduce_sum``, ``hierarchical_psum``, ``tree_psum``,
``topology.PallasRing.reduce``) under ``runtime.trace``'s ``comm`` group
(``collective``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import trace


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


# The data group of a mesh with a model axis (a LevelGroup), or None: the
# default group; and the global ranks of every model index's data group,
# in model order (the groups ``level_groups`` lays a topology over).
_DATA: Optional["LevelGroup"] = None
_DATA_ALL: Tuple[Tuple[int, ...], ...] = ()


def set_data_group(lg: Optional["LevelGroup"],
                   every: Optional[Sequence[Sequence[int]]] = None) -> None:
    """Make ``lg`` the data-parallel group of this process (None: the
    default group). ``every`` lists the ranks of each model index's data
    group, in model order (default: ``lg``'s alone).
    ``launch.mesh.make_mesh`` calls this."""
    global _DATA, _DATA_ALL
    _DATA = lg
    _DATA_ALL = tuple(tuple(r) for r in every) if every is not None \
        else ((tuple(lg.ranks),) if lg is not None else ())


def data_group() -> Optional["LevelGroup"]:
    """The registered data group, or None (the default group)."""
    return _DATA


def data_world_size() -> int:
    """Number of data-parallel shards: the registered data group's size,
    else the default group's, or 1."""
    if _DATA is not None:
        return _DATA.size
    return dist.get_world_size() if _initialized() else 1


def collective(x: torch.Tensor):
    """One collective of the data group on ``x``: counted when the group
    has more than one rank (``comm``: a call, and the payload's bytes in
    the dtype it travels in), and the ``comm.all_reduce`` span to run it
    in."""
    if data_world_size() > 1:
        comm = trace.counters["comm"]
        comm["calls"] += 1
        comm["bytes"] += x.numel() * x.element_size()
    return trace.span("comm.all_reduce")


def all_reduce_sum(x: torch.Tensor, *, async_op: bool = False, group=None
                   ) -> Tuple[torch.Tensor, Optional[object]]:
    """Sum ``x`` in place across ``group`` (default: the data group).

    Returns ``(x, work)``: ``work`` is the async handle to ``wait()`` on
    when ``async_op`` is set and a group exists, else None (the sum is
    complete on return, or there was nothing to sum)."""
    if not _initialized():
        return x, None
    if group is None and _DATA is not None:
        if _DATA.size == 1:
            return x, None
        group = _DATA.group
    with collective(x):
        work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group,
                               async_op=async_op)
    return x, (work if async_op else None)


def reduce_pool(x: torch.Tensor, algo=None) -> torch.Tensor:
    """Sum ``x`` across the data-parallel group (synchronously, in place).
    ``algo`` is a ``topology`` algorithm object; None means flat."""
    if algo is None:
        return all_reduce_sum(x)[0]
    out, work = algo.reduce(x)
    return out


def ring_perm(n: int) -> list:
    """The unidirectional ring: rank d sends to (d + 1) % n. One such
    exchange is one ring *step*; a ring all-reduce is 2(n-1) of them."""
    return [(d, (d + 1) % n) for d in range(n)]


# -- level groups --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelGroup:
    """This rank's group along one level (or a set of levels): the
    process group (None when it holds one rank, or without a default
    group), the global ranks in group order, and this rank's position."""

    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def nccl(self) -> bool:
        return self.group is not None and dist.get_backend(self.group) == "nccl"


@dataclasses.dataclass(frozen=True)
class LevelGroups:
    """Every group of one topology shape that holds this rank."""

    levels: Tuple[LevelGroup, ...]   # per level, slowest first
    outer: Optional[LevelGroup]      # all levels but the innermost


_GROUPS: Dict[Tuple[int, ...], LevelGroups] = {}
_SOLO = LevelGroup(group=None, ranks=(0,), index=0)


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _groups_over(keep: Sequence[int], sizes: Sequence[int], me: int,
                 ranks_of: Optional[Sequence[int]] = None
                 ) -> Optional[LevelGroup]:
    """Create one group per coordinate of the levels outside ``keep``
    (row-major order), spanning the levels in ``keep``; return the one
    that holds ``me`` (None when none does). ``ranks_of`` maps a
    topology index to its global rank (default: the index itself).
    Every rank calls this in the same order."""
    others = [l for l in range(len(sizes)) if l not in keep]
    mine = None
    for fixed in itertools.product(*[range(sizes[l]) for l in others]):
        ranks = []
        for var in itertools.product(*[range(sizes[l]) for l in keep]):
            coords = [0] * len(sizes)
            for l, c in zip(others, fixed):
                coords[l] = c
            for l, c in zip(keep, var):
                coords[l] = c
            i = _rank_of(coords, sizes)
            ranks.append(ranks_of[i] if ranks_of is not None else i)
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if me in ranks:
            mine = LevelGroup(group=group, ranks=tuple(ranks),
                              index=ranks.index(me))
    return mine


def level_groups(topo) -> LevelGroups:
    """The groups of ``topo``'s shape that hold this rank, created on
    first use (collectively: every rank must call this for the same
    shapes in the same order). ``topo=None`` is one level over the
    default group. Without a default group every group is this rank
    alone."""
    sizes = tuple(lv.size for lv in topo.levels) if topo is not None \
        else (data_world_size(),)
    if _DATA is not None:
        return _data_level_groups(sizes)
    if not _initialized():
        assert all(s == 1 for s in sizes), (
            f"a topology of {sizes} ranks needs a process group")
        return LevelGroups(levels=(_SOLO,) * len(sizes),
                           outer=_SOLO if len(sizes) > 1 else None)
    world = dist.get_world_size()
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"topology of {sizes} ranks on a world of {world}")
    found = _GROUPS.get(sizes)
    if found is None:
        me = dist.get_rank()
        if len(sizes) == 1:
            levels = (LevelGroup(group=dist.group.WORLD,
                                 ranks=tuple(range(world)), index=me),)
            outer = None
        else:
            levels = tuple(_groups_over([l], sizes, me)
                           for l in range(len(sizes)))
            outer = _groups_over(list(range(len(sizes) - 1)), sizes, me)
        found = _GROUPS[sizes] = LevelGroups(levels=levels, outer=outer)
    return found


def _data_level_groups(sizes: Tuple[int, ...]) -> LevelGroups:
    """``level_groups`` under a model axis: the topology's levels laid
    over the registered data group's ranks (row-major over its index),
    the groups of every model index's data group created in model order
    on every rank."""
    n = 1
    for s in sizes:
        n *= s
    if n != _DATA.size:
        raise ValueError(f"a data topology of {sizes} ranks over a data "
                         f"group of {_DATA.size}")
    if len(sizes) == 1 or _DATA.size == 1:
        solo = _DATA if _DATA.size > 1 else _SOLO
        return LevelGroups(levels=(solo,) * len(sizes),
                           outer=solo if len(sizes) > 1 else None)
    key = (sizes, _DATA_ALL)
    found = _GROUPS.get(key)
    if found is None:
        me = dist.get_rank()
        levels: List[Optional[LevelGroup]] = [None] * len(sizes)
        outer = None
        for ranks in _DATA_ALL:
            for l in range(len(sizes)):
                levels[l] = _groups_over([l], sizes, me, ranks) or levels[l]
            outer = _groups_over(list(range(len(sizes) - 1)), sizes, me,
                                 ranks) or outer
        found = _GROUPS[key] = LevelGroups(levels=tuple(levels), outer=outer)
    return found


def ring_levels(topo) -> List[LevelGroup]:
    """The groups one ring runs over per level, innermost first."""
    return list(reversed(level_groups(topo).levels))


# -- two-level and tree --------------------------------------------------------


def _sum_over(x: torch.Tensor, lg: LevelGroup) -> torch.Tensor:
    """Sum ``x`` in place across one level group (nothing on one rank)."""
    if lg.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=lg.group)
    return x


def _pad_to_multiple(x: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-x.shape[0]) % m
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    return x


def _reduce_scatter(x: torch.Tensor, lg: LevelGroup
                    ) -> Tuple[torch.Tensor, int]:
    """Sum the (lg.size * seg,) buffer across the group; returns this
    rank's summed segment and its index. NCCL runs
    ``reduce_scatter_tensor`` (segment = the group index); gloo has no
    reduce-scatter, so the plain ring twin's reduce-scatter half runs
    instead (segment = index + 1 mod n, as the ring leaves it)."""
    n = lg.size
    seg = x.shape[0] // n
    if lg.nccl:
        out = x.new_empty((seg,))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=lg.group)
        return out, lg.index
    from repro_torch.kernels import ref
    acc, own = ref.ring_reduce_scatter(x, lg, seg, x.dtype)
    return acc[own * seg:(own + 1) * seg].to(x.dtype), own


def _all_gather(shard: torch.Tensor, own: int, lg: LevelGroup
                ) -> torch.Tensor:
    """Every rank's summed segment back in segment order."""
    n = lg.size
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard.contiguous(), group=lg.group)
    owners = [j if lg.nccl else (j + 1) % n for j in range(n)]
    out = [None] * n
    for j, seg in zip(owners, parts):
        out[j] = seg
    return torch.cat(out)


def hierarchical_psum(x: torch.Tensor, topo) -> torch.Tensor:
    """Two-level all-reduce: reduce-scatter over the innermost level,
    all-reduce the shard over all outer levels, all-gather back over the
    innermost level. Outer-level traffic per rank drops from |x| to
    |x| / inner size (the paper's NCCL-H, Fig 7b)."""
    groups = level_groups(topo)
    inner = groups.levels[-1]
    with collective(x):
        if groups.outer is None:
            return _sum_over(x, inner)
        if inner.size == 1:
            return _sum_over(x, groups.outer)
        xp = _pad_to_multiple(x, inner.size)
        shard, own = _reduce_scatter(xp, inner)
        _sum_over(shard, groups.outer)
        return _all_gather(shard, own, inner)[:x.shape[0]]


def tree_psum(x: torch.Tensor, topo) -> torch.Tensor:
    """k-level tree all-reduce: reduce-scatter from the innermost level
    outward, all-reduce over the outermost level on a shard shrunk by all
    inner sizes, then all-gather back down. Equals ``hierarchical_psum``
    on two levels."""
    with collective(x):
        return _tree(x, list(level_groups(topo).levels))


def _tree(x: torch.Tensor, levels: List[LevelGroup]) -> torch.Tensor:
    inner = levels[-1]
    if len(levels) == 1:
        return _sum_over(x, inner)
    if inner.size == 1:
        return _tree(x, levels[:-1])
    xp = _pad_to_multiple(x, inner.size)
    shard, own = _reduce_scatter(xp, inner)
    shard = _tree(shard, levels[:-1])
    return _all_gather(shard, own, inner)[:x.shape[0]]

"""Topology-aware collective backend — the port of the JAX package's
``parallel/topology.py``.

* ``Topology`` — the data-parallel ranks modelled as bandwidth/latency
  *levels* (slowest first), each with its calibrated ``Fabric``
  (``repro_torch.parallel.cost_model``). Ranks map onto levels in
  row-major order: ``rank = Σ coord_l · stride_l``, the last level
  fastest-varying (``collectives.level_groups``).
* a registry of ``ReduceAlgorithm`` objects — the flat all-reduce, the
  two-level reduce-scatter → all-reduce → all-gather, the k-level tree,
  and the *owned* ``pallas_ring`` (the 2(N-1)-step ring run by this
  package's CUDA kernel, one ring per level) — each knowing how to
  *execute* over ``torch.distributed`` (``reduce``) and what it should
  *cost* on a topology (``predicted_time``, equal to the JAX package's).
* ``select_algorithm`` picks the cheapest applicable algorithm per
  message size; ``auto_bucket_boundaries`` tunes the lazy-allreduce
  bucket size θ.

``reduce(x, topo, async_op=...)`` returns ``(result, work)``: ``work`` is
None when the result is complete on return, else a handle whose
``wait()`` makes the caller's stream wait for it. ``topo=None`` means one
level over the whole default group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import collectives
from repro_torch.parallel.cost_model import (Fabric, HOST_LOOPBACK, INTRA_NODE,
                                             NCCL_56G, all_gather_time,
                                             bucket_release_times,
                                             overlapped_finish_time,
                                             reduce_scatter_time,
                                             ring_allreduce_time,
                                             sequential_ring_time,
                                             staged_finish_time, update_time)


# -- the topology model ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Level:
    """One bandwidth/latency level of the reduction: its axis name, its
    degree and its fabric. Levels are ordered slowest FIRST."""

    axis: str
    size: int
    fabric: Fabric


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

    @property
    def innermost(self) -> Level:
        return self.levels[-1]

    @property
    def slowest_fabric(self) -> Fabric:
        return min((lv.fabric for lv in self.levels),
                   key=lambda f: f.bw_peak)

    def restrict(self, axes: Sequence[str]) -> "Topology":
        """Sub-topology covering only ``axes`` (order preserved)."""
        keep = tuple(lv for lv in self.levels if lv.axis in set(axes))
        return Topology(levels=keep)

    # -- constructors --------------------------------------------------------

    @staticmethod
    def flat(axis: str, size: int, fabric: Fabric = NCCL_56G) -> "Topology":
        return Topology(levels=(Level(axis, size, fabric),))

    @staticmethod
    def from_axis_sizes(axes: Sequence[str], sizes: Sequence[int],
                        fabrics: Optional[Sequence[Fabric]] = None,
                        ) -> "Topology":
        """Build from parallel (axes, sizes) lists, slowest first. Without
        ``fabrics`` the innermost level gets the intra-node fabric and
        every outer level the 56G inter-node wire."""
        axes = tuple(axes)
        sizes = tuple(int(s) for s in sizes)
        assert len(axes) == len(sizes) and axes, (axes, sizes)
        if fabrics is None:
            fabrics = [NCCL_56G] * (len(axes) - 1) + [INTRA_NODE]
        return Topology(levels=tuple(
            Level(a, s, f) for a, s, f in zip(axes, sizes, fabrics)))

    @staticmethod
    def cluster_v(nodes: int = 64, gpus_per_node: int = 8) -> "Topology":
        """The paper's Cluster-V: V100 nodes on the 56 Gbps fabric."""
        return Topology.from_axis_sizes(
            ("node", "gpu"), (nodes, gpus_per_node),
            fabrics=(NCCL_56G, INTRA_NODE))

    @staticmethod
    def host_mesh(axes: Sequence[str], sizes: Sequence[int]) -> "Topology":
        """Every level on the loopback fabric (tests and simulations)."""
        return Topology.from_axis_sizes(
            axes, sizes, fabrics=[HOST_LOOPBACK] * len(tuple(axes)))


def mesh_topology(world_size: int,
                  topology: Optional[Topology] = None,
                  data_shape: Optional[Sequence[int]] = None) -> Topology:
    """The data-parallel topology of ``world_size`` data ranks: the given
    ``topology`` (which must cover exactly that many ranks), else what
    the JAX package's ``launch.mesh.mesh_topology`` derives from the
    mesh's data axes: one ``('data', N)`` level, or with ``data_shape``
    (P, D), a ('pod', 'data') mesh's, the levels ``('pod', P)`` (the
    inter-node fabric) and ``('data', D)`` (the intra-node one)."""
    if topology is None:
        shape = tuple(data_shape) if data_shape else (world_size,)
        if math.prod(shape) != world_size:
            raise ValueError(f"data axes of {shape} for {world_size} data "
                             f"ranks")
        if len(shape) > 2:
            raise ValueError(f"at most two data axes, got {shape}")
        return Topology.from_axis_sizes(("pod", "data")[-len(shape):],
                                        shape)
    if topology.num_devices != world_size:
        raise ValueError(f"topology {topology.axes} covers "
                         f"{topology.num_devices} ranks, the world has "
                         f"{world_size}")
    return topology


# -- reduce algorithms -------------------------------------------------------


class ReduceAlgorithm:
    """One way to sum a buffer across the data-parallel ranks: ``reduce``
    runs it over ``torch.distributed``, ``predicted_time`` prices one
    reduction of ``msg_bytes`` on a ``Topology``."""

    name: str = "?"
    min_levels: int = 1

    def reduce(self, x: torch.Tensor, topo: Optional[Topology] = None, *,
               async_op: bool = False):
        raise NotImplementedError

    def predicted_time(self, msg_bytes: float, topo: Topology) -> float:
        raise NotImplementedError

    def applicable(self, topo: Topology) -> bool:
        return len(topo.levels) >= self.min_levels

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class FlatRing(ReduceAlgorithm):
    """One all-reduce over every rank (NCCL picks its own ring or tree on
    the card); priced as a single ring across the slowest links."""

    name = "flat"

    def reduce(self, x, topo=None, *, async_op=False):
        return collectives.all_reduce_sum(x, async_op=async_op)

    def predicted_time(self, msg_bytes, topo):
        return ring_allreduce_time(msg_bytes, topo.num_devices,
                                   topo.slowest_fabric)


class TwoLevel(ReduceAlgorithm):
    """reduce-scatter over the innermost level → all-reduce the shard over
    all outer levels → all-gather back."""

    name = "two_level"
    min_levels = 2

    def reduce(self, x, topo=None, *, async_op=False):
        return collectives.hierarchical_psum(x, topo), None

    def predicted_time(self, msg_bytes, topo):
        inner = topo.innermost
        outer = topo.restrict([lv.axis for lv in topo.levels[:-1]])
        t = reduce_scatter_time(msg_bytes, inner.size, inner.fabric)
        if outer.levels:
            t += ring_allreduce_time(msg_bytes / inner.size,
                                     outer.num_devices,
                                     outer.slowest_fabric)
        t += all_gather_time(msg_bytes, inner.size, inner.fabric)
        return t


class TreeReduce(ReduceAlgorithm):
    """k-level tree: recursive reduce-scatter down the level stack, an
    all-reduce at the top, all-gather back up."""

    name = "tree"
    min_levels = 2

    def reduce(self, x, topo=None, *, async_op=False):
        return collectives.tree_psum(x, topo), None

    def predicted_time(self, msg_bytes, topo):
        if len(topo.levels) == 1:
            lv = topo.levels[0]
            return ring_allreduce_time(msg_bytes, lv.size, lv.fabric)
        inner = topo.innermost
        t = reduce_scatter_time(msg_bytes, inner.size, inner.fabric)
        t += self.predicted_time(msg_bytes / inner.size,
                                 Topology(levels=topo.levels[:-1]))
        t += all_gather_time(msg_bytes, inner.size, inner.fabric)
        return t


class PallasRing(ReduceAlgorithm):
    """The ring all-reduce, *owned*: the 2(N-1)-step reduce-scatter +
    all-gather run by this package (``kernels.ops.ring_allreduce``: the
    CUDA kernel for CUDA tensors, the plain twin over the process group
    for CPU tensors), one full-payload ring per level, innermost first.
    Segments travel in the bucket's dtype with f32 accumulation.

    On the card each level's ring runs over that level group's workspace,
    set up once by ``kernels.ops.ring_prepare`` (the Trainer does it) and
    shared by every bucket. The JAX package stamps a collective id per
    bucket (``with_id``) because its ring kernels share one compiled
    program; the port's rings run one after another on one stream and
    need none. The name is the JAX package's (its ring is a Pallas
    kernel)."""

    name = "pallas_ring"

    def reduce(self, x, topo=None, *, async_op=False):
        from repro_torch.kernels import ops
        with collectives.collective(x):
            return ops.ring_allreduce(x, collectives.ring_levels(topo),
                                      async_op=async_op)

    def predicted_time(self, msg_bytes, topo):
        return sequential_ring_time(
            msg_bytes, [(lv.size, lv.fabric) for lv in topo.levels])


FLAT = FlatRing()
TWO_LEVEL = TwoLevel()
TREE = TreeReduce()
PALLAS_RING = PallasRing()

REGISTRY: Dict[str, ReduceAlgorithm] = {}


def register_algorithm(algo: ReduceAlgorithm) -> ReduceAlgorithm:
    REGISTRY[algo.name] = algo
    return algo


for _a in (FLAT, TWO_LEVEL, TREE, PALLAS_RING):
    register_algorithm(_a)


def get_algorithm(name: str) -> ReduceAlgorithm:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collective_algo {name!r}; "
            f"registered: {sorted(REGISTRY)}") from None


# -- auto-selection ----------------------------------------------------------


def select_algorithm(msg_bytes: float, topo: Topology,
                     ) -> Tuple[ReduceAlgorithm, float]:
    """Cheapest applicable algorithm for one message on this topology;
    the flat ring wins ties."""
    best, best_t = FLAT, FLAT.predicted_time(msg_bytes, topo)
    for algo in REGISTRY.values():
        if algo is FLAT or not algo.applicable(topo):
            continue
        t = algo.predicted_time(msg_bytes, topo)
        if t < best_t:
            best, best_t = algo, t
    return best, best_t


def resolve_algorithm(collective_algo: str, topo: Optional[Topology],
                      msg_bytes: float = 0.0) -> ReduceAlgorithm:
    """Config string -> algorithm object (GradientFlow's entry point).
    'auto' prices the candidates on the topology (the flat ring without
    one, or on one level); explicit names resolve through the registry."""
    if collective_algo == "auto":
        if topo is None or len(topo.levels) < 2:
            return FLAT
        return select_algorithm(msg_bytes, topo)[0]
    return get_algorithm(collective_algo)


# -- θ auto-tuning -----------------------------------------------------------


def _pow2_candidates(lo: int, hi: int) -> List[int]:
    out, c = [], lo
    while c < hi:
        out.append(c)
        c *= 2
    out.append(hi)
    return out


def auto_bucket_boundaries(
    pool, wire_dtype, topo: Topology, *,
    collective_algo: str = "auto",
    backward_s: Optional[float] = None,
    min_bucket_elems: int = 256 * 1024,
    update_bw: Optional[float] = None,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Pick the lazy-allreduce threshold θ for this pool and topology
    (paper §3.1's tradeoff): for each power-of-two θ, price every
    tensor-aligned bucket with the algorithm that will run it, release
    buckets at the uniform backward rate, and keep the θ whose step
    finishes first — the last collective (comm-only) or, with
    ``update_bw``, the last per-bucket update of the staged pipeline.
    ``backward_s`` defaults to the flat-ring time of the whole pool.
    Returns ``(theta, boundaries)``."""
    if isinstance(wire_dtype, str):
        wire_dtype = getattr(torch, wire_dtype)
    elt = torch.empty((), dtype=wire_dtype).element_size()
    if backward_s is None:
        backward_s = FLAT.predicted_time(pool.size * elt, topo)

    def _bucket_time(nbytes: float) -> float:
        algo = resolve_algorithm(collective_algo, topo, nbytes)
        return algo.predicted_time(nbytes, topo)

    best_theta, best_finish, best_bounds = pool.size, float("inf"), None
    for theta in _pow2_candidates(min(min_bucket_elems, pool.size),
                                  pool.size):
        bounds = pool.bucket_boundaries(theta)
        sizes = [(e - s) * elt for s, e in bounds]
        times = [_bucket_time(b) for b in sizes]
        rel = bucket_release_times(sizes, backward_s)
        if update_bw is not None:
            upd = [update_time(e - s, update_bw) for s, e in bounds]
            finish = staged_finish_time(times, rel, upd)
        else:
            finish = overlapped_finish_time(times, rel)
        if finish < best_finish - 1e-12:
            best_theta, best_finish, best_bounds = theta, finish, bounds
    return best_theta, best_bounds

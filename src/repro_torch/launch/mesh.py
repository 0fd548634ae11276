"""Meshes of the port: a ('data', 'model') or ('pod', 'data', 'model')
grid over the ranks of the default process group.

``make_mesh(shape, axes)`` lays the ranks out row-major with the model
index fastest, as the JAX package orders a mesh's devices: rank =
(p * D + d) * M + m (p = 0 on a two-axis grid). The data index of a rank
is p * D + d, its place across pod x data. Every rank creates the grid's
process groups in one order (collectively): one model group for each
data index (gloo: on the card the model ranks share a device, and NCCL
refuses two ranks on one), then one data group for each model index (the
default backend), over its P x D ranks in data-index order. With a model
axis (M > 1) the mesh registers its data group, and every model index's
data group's ranks, as the process's data-parallel group
(``parallel.collectives``): the gradient reductions, the metrics' mean
and ``level_groups`` (a topology's levels inside the data group) run
over it, not over the default group. With M = 1 the data group is the
default group and nothing changes.

``mesh_topology`` is the JAX package's: the bandwidth levels of a mesh's
data axes ('pod' the slower level, 'data' the faster). The JAX package's
``make_production_mesh`` (the 16x16 and 2x16x16 TPU pods) has no
counterpart here (ROADMAP.md C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import LevelGroup
from repro_torch.parallel.cost_model import Fabric
from repro_torch.parallel.topology import Topology

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def axes_for(shape: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a grid of ``shape``, as the JAX CLI names them:
    ('data', 'model') for two sizes, ('pod', 'data', 'model') for
    three."""
    if len(shape) == 2:
        return AXES
    if len(shape) == 3:
        return POD_AXES
    raise ValueError(f"the port's meshes have 2 or 3 axes, got shape "
                     f"{tuple(shape)}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') or ('pod', 'data', 'model') grid of ranks,
    seen from one rank: ``shape``, this rank's model group (the M ranks
    of its data index) and data group (the P x D ranks of its model
    index)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    model_group: LevelGroup
    data_group: LevelGroup

    @property
    def devices(self) -> np.ndarray:
        """The grid's ranks in mesh order (the JAX mesh's device array)."""
        return np.arange(math.prod(self.shape)).reshape(self.shape)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The data axes, slowest first: ('data',) or ('pod', 'data')."""
        return tuple(self.axis_names[:-1])

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[:-1])

    @property
    def num_data(self) -> int:
        return math.prod(self.data_shape)

    @property
    def model_size(self) -> int:
        return self.shape[-1]

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _group(ranks, me: int, backend: Optional[str] = None):
    """A group over ``ranks`` (None for one rank); every rank calls
    this."""
    group = dist.new_group(list(ranks), backend=backend) \
        if len(ranks) > 1 else None
    return LevelGroup(group=group, ranks=tuple(ranks),
                      index=ranks.index(me)) if me in ranks else None


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None
              ) -> Mesh:
    """The grid of ``shape`` ((D, M) or (P, D, M); ``axes`` default to
    ``axes_for(shape)`` and must equal them) over the default group's
    ranks (the product must be its size; one process without a group is
    the (1, 1) mesh). Collective: every rank calls it, in one order with
    its other group creations."""
    shape = tuple(int(s) for s in shape)
    want = axes_for(shape)
    if axes is not None and tuple(axes) != want:
        raise ValueError(f"a mesh of shape {shape} has axes {want}, got "
                         f"{tuple(axes)}")
    n, m = math.prod(shape[:-1]), shape[-1]
    world, me = _world()
    if n * m != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{n * m} ranks, the world has {world}")
    if m == 1:
        data = LevelGroup(group=dist.group.WORLD if world > 1 else None,
                          ranks=tuple(range(world)), index=me)
        model = LevelGroup(group=None, ranks=(me,), index=0)
        collectives.set_data_group(None)
        return Mesh(shape, want, me, model, data)
    model = data = None
    for i in range(n):
        model = _group([i * m + j for j in range(m)], me, "gloo") or model
    every = [[i * m + j for i in range(n)] for j in range(m)]
    for ranks in every:
        data = _group(ranks, me) or data
    collectives.set_data_group(data, every)
    return Mesh(shape, want, me, model, data)


def make_host_mesh() -> Mesh:
    """The (1, 1) mesh of one process."""
    return make_mesh((1, 1), AXES)


def mesh_topology(mesh, data_axes: Sequence[str],
                  fabrics: Optional[Sequence[Fabric]] = None
                  ) -> Optional[Topology]:
    """Bandwidth/latency levels of a mesh's data axes (slowest first),
    the JAX package's: one level a data axis, in the mesh's axis order;
    None when the mesh has no data axis (pure tensor parallelism)."""
    data_axes = tuple(data_axes)
    if not data_axes:
        return None
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return Topology.from_axis_sizes(
        data_axes, [sizes[a] for a in data_axes], fabrics=fabrics)

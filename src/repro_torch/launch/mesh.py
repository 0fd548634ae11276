"""Meshes of the port: a ('data', 'model') grid over the ranks of the
default process group.

``make_mesh((D, M), ('data', 'model'))`` lays the D x M ranks out
row-major with the model index fastest, as the JAX package orders a
mesh's devices: rank = d * M + m. Every rank creates the grid's process
groups in one order (collectively): one model group for each data index
(gloo: on the card the model ranks share a device, and NCCL refuses two
ranks on one), then one data group for each model index (the default
backend). With a model axis (M > 1) the mesh registers its data group as
the process's data-parallel group (``parallel.collectives``): the
gradient reductions, the metrics' mean and ``level_groups`` run over it,
not over the default group. With M = 1 the data group is the default
group and nothing changes.

``mesh_topology`` is the JAX package's: the bandwidth levels of a mesh's
data axes. The JAX package's ``make_production_mesh`` (the 16x16 and
2x16x16 TPU pods) has no counterpart here (ROADMAP.md C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import LevelGroup
from repro_torch.parallel.cost_model import Fabric
from repro_torch.parallel.topology import Topology

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') grid of ranks, seen from one rank: ``shape``
    (D, M), this rank's model group (the M ranks of its data index) and
    data group (the D ranks of its model index)."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    rank: int
    model_group: LevelGroup
    data_group: LevelGroup

    @property
    def devices(self) -> np.ndarray:
        """The grid's ranks in mesh order (the JAX mesh's device array)."""
        return np.arange(self.shape[0] * self.shape[1]).reshape(self.shape)

    @property
    def num_data(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]


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


def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES) -> Mesh:
    """The ('data', 'model') grid of ``shape`` over the default group's
    ranks (D x M must be its size; one process without a group is the
    (1, 1) mesh). Collective: every rank calls it, in one order with its
    other group creations."""
    shape = tuple(int(s) for s in shape)
    if tuple(axes) != AXES or len(shape) != 2:
        raise ValueError(f"the port's meshes are ('data', 'model') grids, "
                         f"got axes {tuple(axes)} and shape {shape}")
    d, m = shape
    world, me = _world()
    if d * m != world:
        raise ValueError(f"a {d}x{m} mesh needs {d * m} ranks, the world "
                         f"has {world}")
    if m == 1:
        data = LevelGroup(group=dist.group.WORLD if world > 1 else None,
                          ranks=tuple(range(world)), index=me)
        model = LevelGroup(group=None, ranks=(me,), index=0)
        collectives.set_data_group(None)
        return Mesh(shape, AXES, me, model, data)
    model = data = None
    for i in range(d):
        model = _group([i * m + j for j in range(m)], me, "gloo") or model
    for j in range(m):
        data = _group([i * m + j for i in range(d)], me) or data
    collectives.set_data_group(data)
    return Mesh(shape, AXES, me, model, data)


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

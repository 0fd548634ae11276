"""Elastic scaling controller (pure Python; the same policy as the JAX
package's ``repro/runtime/elastic.py``).

Decides mesh transitions when capacity changes (stragglers evicted, nodes
recovered, preemption notices). Mesh candidates keep the 'model' axis
fixed (TP degree is an architecture property) and scale the data axes —
so elastic events never change per-layer sharding, only the DP degree
and per-shard batch. In PyTorch a new world size is a relaunch: the new
processes restore the checkpoint (``checkpoint.reshard.reshard_hg`` for
CSC's per-rank rows) and build their Trainer; ``Trainer.replan`` covers a
topology change over the same ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def candidates_for(num_devices: int, model_parallel: int,
                   pods: int = 1) -> Optional[MeshCandidate]:
    """Largest viable mesh with the given (fixed) model-parallel degree."""
    if num_devices % (model_parallel * pods) != 0:
        return None
    data = num_devices // (model_parallel * pods)
    if data < 1:
        return None
    if pods > 1:
        return MeshCandidate((pods, data, model_parallel),
                             ("pod", "data", "model"))
    return MeshCandidate((data, model_parallel), ("data", "model"))


class ElasticController:
    def __init__(self, model_parallel: int, global_batch: int):
        self.model_parallel = model_parallel
        self.global_batch = global_batch

    def propose(self, healthy_devices: int, pods: int = 1
                ) -> Optional[MeshCandidate]:
        """Largest mesh that (a) fits the healthy devices, (b) keeps TP
        degree, (c) divides the global batch."""
        # Healthy-device counts arrive raw (e.g. 250 after evictions) and
        # rarely divide model_parallel*pods exactly; a mesh only needs to
        # FIT, so round down to the largest usable multiple before the
        # step-down search. Without this, propose(250, mp=16) returned
        # None even though a viable 240-device mesh exists.
        unit = self.model_parallel * pods
        cand = candidates_for((healthy_devices // unit) * unit,
                              self.model_parallel, pods)
        while cand is not None:
            data_total = cand.num_devices // self.model_parallel
            if self.global_batch % data_total == 0:
                return cand
            cand = candidates_for(
                cand.num_devices - self.model_parallel * pods,
                self.model_parallel, pods)
        return None

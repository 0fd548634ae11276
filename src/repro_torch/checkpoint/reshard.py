"""Elastic resharding: restore a checkpoint at a *different* data degree.

Checkpoints store full logical arrays (``manager.py``), so resharding is a
placement problem, not a data transform: ``place`` moves every leaf to the
new process's device. The pool-space optimizer state is the same on every
rank, so elastic scaling changes *only* the data-parallel degree — the
global batch is re-split (``reshard_batch_split``) and the data pipeline's
(step, shard)-pure indexing keeps the sample order. The leaves held one
row a data rank (``manager.ROW_LEAF_NAMES``) are the only ones whose shape
follows the degree: CSC's ``hg`` is re-split by ``reshard_hg``; a low-bit
wire's error-feedback ``residual`` has no reshard (as in the JAX package),
so restoring it at another degree is refused by the shape check.

In PyTorch a new world size is a relaunch: the new processes restore (into
a host state of the old layout, when ``hg`` must be re-split), reshard and
build their Trainer. ``plan`` checks feasibility first, so a supervisor
can choose between world sizes before moving bytes.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import ROW_LEAF_NAMES, flatten, rebuild


def plan(leaf_shapes: Iterable[Tuple[str, Sequence[int]]], world_size: int
         ) -> List[str]:
    """Problems (empty = resharding is feasible) of placing leaves of the
    given (name, logical shape) — e.g. a manifest's — on ``world_size``
    data ranks: the only axis the port shards is the data degree, on
    dim 0 of the row leaves, which must divide by it (the JAX package's
    check of a ``P('data', ...)`` dimension)."""
    problems = []
    for name, shape in leaf_shapes:
        shape = tuple(shape)
        if name not in ROW_LEAF_NAMES or shape == (1, 0):
            continue
        if not shape or shape[0] % world_size != 0:
            problems.append(f"dim 0 of shape {shape} not divisible by "
                            f"{world_size} (data)")
    return problems


def place(state: Any, device: Union[str, torch.device]) -> Any:
    """Every tensor leaf moved to ``device`` (other leaves as they are)."""
    return rebuild(state, [x.to(device) if isinstance(x, torch.Tensor)
                           else x for _, x in flatten(state)])


def reshard_hg(old_hg: np.ndarray, new_num_data: int) -> np.ndarray:
    """Re-distribute CSC's per-rank historical gradients across a new
    data-parallel degree.

    The algorithm consumes hg additively before the all-reduce
    (Algorithm 1 line 7), and the reduced pool is divided by the number
    of ranks, so the history a step re-injects is the column total over
    N. Keeping the column total, as this does, is exact for N' = N; at
    another N' it rescales the re-injected history by N / N' (ROADMAP.md
    C records this caveat of the JAX package's reshard, kept here). The
    total is split evenly across the new ranks to keep per-rank
    magnitudes (and the L1 norm census) balanced. numpy arithmetic, as
    in the JAX package, so both give the same bits.
    """
    total = np.asarray(old_hg).sum(axis=0, keepdims=True)
    return np.tile(total / new_num_data, (new_num_data, 1))


def reshard_batch_split(global_batch: int, old_shards: int,
                        new_shards: int) -> Tuple[int, int]:
    """(old_per_shard, new_per_shard) batch sizes after an elastic
    change of the data degree."""
    for n in (old_shards, new_shards):
        if global_batch % n:
            raise ValueError(f"global batch {global_batch} not divisible "
                             f"by {n} shards")
    return global_batch // old_shards, global_batch // new_shards


def host_like(state: Any, num_data: int) -> Any:
    """A host state of ``state``'s structure in the checkpoint's layout at
    ``num_data`` data ranks: each tensor leaf an uninitialised CPU tensor
    of its shape and dtype, each row leaf ``[num_data, n]`` (``(1, 0)``
    when empty). Restore a checkpoint of that degree into it with
    ``CheckpointManager.restore(..., logical=True)``."""
    out = []
    for name, x in flatten(state):
        if not isinstance(x, torch.Tensor):
            out.append(x)
        elif name in ROW_LEAF_NAMES:
            n = x.numel()
            out.append(torch.empty((num_data, n) if n else (1, 0),
                                   dtype=x.dtype))
        else:
            out.append(torch.empty(x.shape, dtype=x.dtype))
    return rebuild(state, out)


def reshard_state(state: Any, new_num_data: int) -> Any:
    """A host state of the checkpoint's layout (``host_like``) re-split
    to ``new_num_data`` data ranks: ``gf/hg`` by ``reshard_hg``. A live
    error-feedback ``residual`` has no reshard (as in the JAX package)
    and raises."""
    out = []
    for name, x in flatten(state):
        if name in ROW_LEAF_NAMES and x.numel() \
                and x.shape[0] != new_num_data:
            if name != "gf/hg":
                raise ValueError(
                    f"{name} of {x.shape[0]} rows has no reshard to "
                    f"{new_num_data} ranks (only hg is re-split)")
            x = torch.from_numpy(reshard_hg(x.numpy(), new_num_data))
        out.append(x)
    return rebuild(state, out)

"""Logical-axis sharding: the JAX package's ``parallel/sharding.py`` rule
tables, in the port.

Every parameter is declared as a ``models.params.ParamSpec`` carrying
logical axis names ('vocab', 'qkv', 'mlp', 'expert', ...). An
architecture's rule table maps each name to the physical 'model' mesh
axis or to None (replicated). This module is the only place where that
mapping happens: the model reads the table through ``logical_spec`` to
pick each weight's form (column-parallel, row-parallel or replicated),
and ``localize_specs`` gives the shapes one model rank holds, from
which the Trainer builds its local gradient pool. The data axes never
appear here.

A leaf sharded on the model axis is split into ``model_size`` equal
contiguous blocks along that dimension; model rank r holds block r, as a
``NamedSharding`` places a ``'model'``-split dimension on the mesh's
devices in model order. ``shard_tree`` and ``unshard_tree`` cut a full
tree into one rank's blocks and put the blocks back together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

Rules = Mapping[str, Optional[str]]


def _map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def logical_spec(axes: Sequence[Optional[str]], rules: Rules
                 ) -> Tuple[Optional[str], ...]:
    """Logical axes -> one mesh-axis name (or None) a dimension, through
    the rule table (the JAX package's ``PartitionSpec``, as a tuple)."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def param_pspecs(specs: Any, rules: Rules) -> Any:
    """The mesh-axis tuple of every leaf of a spec tree."""
    return _map(lambda s: logical_spec(s.axes, rules), specs)


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in _leaves(specs))


def model_dim(spec, rules: Rules) -> Optional[int]:
    """The dimension of ``spec`` the rules put on the model axis, or None
    (replicated)."""
    dims = [i for i, a in enumerate(logical_spec(spec.axes, rules))
            if a == "model"]
    assert len(dims) <= 1, (spec.axes, "two dimensions on one mesh axis")
    return dims[0] if dims else None


def localize_specs(specs: Any, rules: Rules, model_size: int) -> Any:
    """Shapes of the per-model-rank local views of every parameter: each
    dimension the rules put on the model axis divided by ``model_size``.

    The Trainer builds its local gradient pool from these: the pool-space
    optimizer and GradientFlow state live on each model rank's slice of
    the parameters, so packing never gathers a sharded tensor."""
    def loc(s):
        shape = []
        for dim, ax in zip(s.shape, s.axes):
            phys = rules.get(ax) if ax is not None else None
            if phys == "model":
                assert dim % model_size == 0, (
                    f"dim {dim} (axis {ax}) not divisible by model axis "
                    f"{model_size}; fix the arch's rule table")
                shape.append(dim // model_size)
            else:
                shape.append(dim)
        return dataclasses.replace(s, shape=tuple(shape))
    return _map(loc, specs)


def _block(x, dim: Optional[int], model_size: int, model_rank: int):
    if dim is None or model_size == 1:
        return x
    n = x.shape[dim] // model_size
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(model_rank * n, (model_rank + 1) * n)
    return x[tuple(index)]


def shard_tree(full: Any, specs: Any, rules: Rules, model_size: int,
               model_rank: int) -> Any:
    """Model rank ``model_rank``'s blocks of a full parameter tree (numpy
    arrays or tensors: views where the framework gives them)."""
    localize_specs(specs, rules, model_size)  # divisibility check
    return _map(lambda x, s: _block(x, model_dim(s, rules), model_size,
                                    model_rank), full, specs)


def unshard_tree(parts: Sequence[Any], specs: Any, rules: Rules,
                 concat: Callable) -> Any:
    """The full tree from every model rank's blocks (``parts`` in rank
    order); ``concat(blocks, dim)`` joins one leaf's blocks. A replicated
    leaf is taken from rank 0."""
    def join(s, *blocks):
        dim = model_dim(s, rules)
        return blocks[0] if dim is None or len(blocks) == 1 \
            else concat(list(blocks), dim)
    return _map(join, specs, *parts)


# -- serving caches ----------------------------------------------------------

# A serving cache is a tree of NamedTuples (``attention.KVCache``, the
# Mamba states, ``hybrid_lm.HybridCache``) whose leaves carry logical axes
# too (the models' ``cache_logical_axes``). Under the serve rules an axis
# may go to the model axis ('kv_seq', 'kv_heads', 'dinner', 'heads') or to
# the data axes ('serve_batch': a tuple of mesh axes, JAX's
# ``PartitionSpec`` entry), so these helpers take the mesh's axis sizes and
# a rank's coordinates, not only a model degree. A dimension split over
# several mesh axes is split in their order, the first the slowest, as a
# ``NamedSharding`` places it.


def is_axes(x: Any) -> bool:
    """A logical-axes leaf: a plain tuple of axis names (or None)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def map_axes(fn: Callable, axes: Any, *trees: Any) -> Any:
    """``fn(leaf axes, *leaves)`` over a cache's NamedTuples; the result
    has the first tree's types (the axes tree's without one)."""
    if is_axes(axes):
        return fn(axes, *trees)
    kind = type(trees[0]) if trees else type(axes)
    return kind(*(map_axes(fn, a, *(t[i] for t in trees))
                  for i, a in enumerate(axes)))


def mesh_axes(entry: Any) -> Tuple[str, ...]:
    """The mesh axes a rule-table entry names: None none, a name one,
    a tuple its names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _splits(axes: Sequence[Optional[str]], rules: Rules
            ) -> List[Tuple[str, ...]]:
    """The mesh axes of each dimension; one mesh axis on two dimensions
    is refused, as a ``PartitionSpec`` refuses it."""
    out = [mesh_axes(rules.get(a)) if a is not None else () for a in axes]
    used = [m for ms in out for m in ms]
    if len(used) != len(set(used)):
        raise ValueError(f"the rules put one mesh axis on two dimensions "
                         f"of a leaf with logical axes {tuple(axes)}: "
                         f"{dict(zip(axes, out))}")
    return out


def local_shape(shape: Sequence[int], axes: Sequence[Optional[str]],
                rules: Rules, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape one rank holds of a leaf of ``shape`` whose dimensions
    carry ``axes`` (``NamedSharding.shard_shape``); ``sizes`` maps each
    mesh axis to its size. A dimension that does not split whole over
    its mesh axes is refused, named by its logical axis."""
    out = []
    for dim, ax, ms in zip(shape, axes, _splits(axes, rules)):
        n = math.prod(sizes[m] for m in ms)
        if dim % n:
            raise ValueError(f"dimension {ax!r} of size {dim} does not "
                             f"split over {n} ranks ({'x'.join(ms)})")
        out.append(dim // n)
    return tuple(out)


def block_slices(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: Rules, sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """Where the block of the rank at mesh coordinates ``coords`` sits in
    the whole leaf."""
    local = local_shape(shape, axes, rules, sizes)
    out = []
    for n, ms in zip(local, _splits(axes, rules)):
        i = 0
        for m in ms:
            i = i * sizes[m] + coords[m]
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


# -- rule tables -------------------------------------------------------------

# Defaults for dense transformers: Megatron tensor parallelism over 'model'.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",      # embedding + LM head vocab-sharded
    "embed": None,         # d_model replicated
    "heads": "model",      # attention heads column-parallel
    "kv_heads": "model",   # sharded when divisible (override per arch)
    "qkv": "model",
    "mlp": "model",        # FFN hidden column/row parallel
    "expert": "model",     # MoE expert-parallel
    "expert_mlp": None,    # per-expert FFN hidden (TP within expert)
    "capacity": None,
    "seq": None,           # sequence parallel (override per shape)
    "kv_seq": None,        # KV-cache sequence sharding for long decode
    "state": None,         # SSM state
    "dinner": "model",     # mamba inner dim
    "conv": None,
    "layers": None,
}


def make_rules(**overrides: Optional[str]) -> Dict[str, Optional[str]]:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules

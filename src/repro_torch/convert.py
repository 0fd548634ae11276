"""Carry parameter trees, optimizer states, loss-scaler states and
serving caches between the JAX package and the port.

The port keeps the JAX package's layout (same nested keys, stacked layer
weights, (in, out) matrices, pool-shaped optimizer state fields of the
same names), so conversion is a key-for-key (field-for-field) copy through
numpy with no transposes. ``shard_params`` and ``unshard_params`` cut a
full tree into one model rank's blocks and put the blocks back together
(``parallel.sharding``); ``shard_cache`` and ``unshard_cache`` do the same
for a serving cache under the serve rules, over the data axes too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[Union[str, torch.device]] = None,
                      ) -> Dict[str, Any]:
    """Nested dict of array-likes (numpy, or anything ``np.asarray``
    takes) -> nested dict of torch tensors on ``device`` (CUDA unless
    ``device`` is given; see ``repro_torch.resolve_device``)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(dev)
    return walk(tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of torch tensors -> nested dict of numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def opt_state_from_numpy(name: str, state: Any,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Any:
    """The optimizer ``name``'s state (``SGDState`` or ``AdamWState``)
    from any object with its fields as array-likes (the JAX package's
    state, or ``opt_state_to_numpy``'s), field for field through numpy,
    on ``device`` (CUDA unless given)."""
    from repro_torch import optim, resolve_device
    dev = resolve_device(device)
    cls = optim.state_type(name)
    return cls(*(torch.from_numpy(np.array(getattr(state, f), copy=True))
                 .to(dev) for f in cls._fields))


def opt_state_to_numpy(state: Any) -> Any:
    """An optimizer state of torch tensors -> the same NamedTuple of numpy
    arrays."""
    return type(state)(*(x.detach().cpu().numpy() for x in state))


def scaler_from_numpy(state: Any,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """An ``optim.scaler.ScalerState`` (0-dim f32 scale, i32 counts) from
    any object with its fields as array-likes (the JAX package's
    ``ScalerState``, or ``scaler_to_numpy``'s), on ``device`` (CUDA unless
    given)."""
    from repro_torch import resolve_device
    from repro_torch.optim.scaler import ScalerState
    dev = resolve_device(device)
    dtypes = (np.float32, np.int32, np.int32)
    return ScalerState(*(
        torch.from_numpy(np.array(getattr(state, f), dtype=dt)).to(dev)
        for f, dt in zip(ScalerState._fields, dtypes)))


def scaler_to_numpy(state: Any) -> Any:
    """A ``ScalerState`` of torch tensors -> the same NamedTuple of 0-dim
    numpy arrays."""
    return type(state)(*(x.detach().cpu().numpy() for x in state))


def gf_state_from_numpy(state: Any,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Any:
    """A ``core.gradientflow.GFState`` (CSC's ``hg`` and chunk norms, the
    low-bit wires' error-feedback ``residual``; empty where unused) from
    any object with those fields as f32 array-likes (the JAX package's
    ``GFState`` of one data shard, or ``gf_state_to_numpy``'s), on
    ``device`` (CUDA unless given). The JAX Trainer stacks ``hg`` and the
    residual per data shard: pass one shard's row."""
    from repro_torch import resolve_device
    from repro_torch.core.gradientflow import GFState
    dev = resolve_device(device)
    return GFState(*(
        torch.from_numpy(np.array(getattr(state, f), dtype=np.float32))
        .reshape(-1).to(dev) for f in GFState._fields))


def gf_state_to_numpy(state: Any) -> Any:
    """A ``GFState`` of torch tensors -> the same NamedTuple of numpy
    arrays."""
    return type(state)(*(x.detach().cpu().numpy() for x in state))


def _cache_types() -> Dict[str, Any]:
    from repro_torch.models.hybrid_lm import HybridCache
    from repro_torch.models.layers.attention import KVCache
    from repro_torch.models.layers.mamba import MambaState
    from repro_torch.models.layers.mamba2 import Mamba2State
    return {c.__name__: c for c in (KVCache, MambaState, Mamba2State,
                                    HybridCache)}


def _tensor_from_numpy(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: the same 2 bytes
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(dev)
    return torch.from_numpy(a).to(dev)


def cache_from_numpy(cache: Any,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Any:
    """A serving cache (``KVCache``, ``MambaState``, ``Mamba2State`` or
    ``HybridCache``, stacked or not) from any NamedTuple of the same
    class name and fields holding array-likes (the JAX package's cache,
    or ``cache_to_numpy``'s), field for field through numpy, the bits
    kept (bf16 arrays of ``ml_dtypes`` too), on ``device`` (CUDA unless
    given)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    types = _cache_types()

    def walk(x):
        name = type(x).__name__
        if name in types:
            cls = types[name]
            return cls(*(walk(getattr(x, f)) for f in cls._fields))
        return _tensor_from_numpy(x, dev)
    return walk(cache)


def cache_to_numpy(cache: Any) -> Any:
    """A serving cache of torch tensors -> the same NamedTuples of numpy
    arrays; a bf16 field becomes ``ml_dtypes.bfloat16`` (which it needs)
    with the same bits."""
    if isinstance(cache, tuple):
        return type(cache)(*(cache_to_numpy(x) for x in cache))
    t = cache.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def shard_params(full: Dict[str, Any], rules, model_size: int,
                 model_rank: int, *, specs: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """One model rank's local leaves (numpy) of a full parameter tree
    (the JAX package's, as numpy): every leaf that ``rules`` put on the
    model axis (through its logical axes in ``specs``, the model's
    ``param_specs``) cut to the rank's contiguous block, the rest whole.
    Carry the result to the port with ``params_from_numpy``."""
    from repro_torch.parallel import sharding
    return sharding.shard_tree(_numpy_tree(full), specs, rules, model_size,
                               model_rank)


def unshard_params(parts, rules, *, specs: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The full parameter tree (numpy) from every model rank's local
    leaves (``parts`` in model-rank order; torch tensors or numpy): the
    inverse of ``shard_params``."""
    from repro_torch.parallel import sharding
    return sharding.unshard_tree(
        [_numpy_tree(p) for p in parts], specs, rules,
        lambda blocks, dim: np.concatenate(blocks, axis=dim))


def _mesh(mesh_shape):
    from repro_torch.launch.mesh import axes_for
    shape = tuple(int(x) for x in mesh_shape)
    return shape, dict(zip(axes_for(shape), shape))


def _coords(shape, rank: int) -> Dict[str, int]:
    from repro_torch.launch.mesh import axes_for
    return dict(zip(axes_for(shape),
                    (int(i) for i in np.unravel_index(rank, shape))))


def shard_cache(cache: Any, axes: Any, rules, mesh_shape, rank: int
                ) -> Any:
    """One rank's blocks (numpy) of a whole serving cache (the JAX
    package's global cache, or ``cache_to_numpy``'s): each field cut
    along the dimensions that the serve rules ``rules`` put on the mesh
    of ``mesh_shape`` ((D, M) or (P, D, M); rank = its row-major place,
    the model index fastest) through its logical axes in ``axes`` (the
    model's ``cache_logical_axes``), the others whole. The result has
    the cache's NamedTuple types; carry it to the port with
    ``cache_from_numpy``."""
    from repro_torch.parallel import sharding
    shape, sizes = _mesh(mesh_shape)
    coords = _coords(shape, rank)

    def cut(ax, x):
        x = np.asarray(x)
        return x[sharding.block_slices(x.shape, ax, rules, sizes, coords)]
    return sharding.map_axes(cut, axes, cache)


def unshard_cache(parts, axes: Any, rules, mesh_shape) -> Any:
    """The whole cache (numpy) from every rank's blocks (``parts`` in
    rank order: torch caches or numpy): the inverse of ``shard_cache``.
    A block that several ranks hold (a replicated dimension) must be the
    same bits on each of them."""
    from repro_torch.parallel import sharding
    shape, sizes = _mesh(mesh_shape)

    def join(ax, *blocks):
        blocks = [_leaf_numpy(b) for b in blocks]
        whole = tuple(n * math.prod(sizes[m] for m in sharding.mesh_axes(
            rules.get(a) if a is not None else None))
            for n, a in zip(blocks[0].shape, ax))
        out = np.empty(whole, blocks[0].dtype)
        seen = np.zeros(whole, bool)
        for r, b in enumerate(blocks):
            where = sharding.block_slices(whole, ax, rules, sizes,
                                          _coords(shape, r))
            if seen[where].any() and out[where].tobytes() != b.tobytes():
                raise ValueError(f"the ranks' copies of a block of a leaf "
                                 f"with axes {ax} differ")
            out[where], seen[where] = b, True
        return out
    return sharding.map_axes(join, axes, *parts)


def _leaf_numpy(x) -> np.ndarray:
    return cache_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _numpy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _numpy_tree(v) if isinstance(v, dict)
            else (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in tree.items()}

"""Carry parameter trees, optimizer states and loss-scaler states
between the JAX package and the port.

The port keeps the JAX package's layout (same nested keys, stacked layer
weights, (in, out) matrices, pool-shaped optimizer state fields of the
same names), so conversion is a key-for-key (field-for-field) copy through
numpy with no transposes.
"""
from __future__ import annotations

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

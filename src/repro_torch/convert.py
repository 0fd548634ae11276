"""Carry parameter trees between the JAX package and the port.

The port keeps the JAX package's layout (same nested keys, stacked layer
weights, (in, out) matrices), so conversion is a key-for-key copy through
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

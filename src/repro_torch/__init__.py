"""PyTorch/CUDA port of the GradientFlow training system.

A second package beside the JAX reference ``repro``: same module names and
layout, PyTorch idiom inside, hand-written CUDA kernels for Hopper where
the JAX package has Pallas kernels. It imports neither ``jax`` nor
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Raises when no device was given and CUDA is missing —
    a run on the CPU has to be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

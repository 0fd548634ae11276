"""The cell's weights, drawn from the run's seed on the device: one
generator a weight, seeded from (seed, the weight's place in sorted
name order), one call a weight, in float32. A weight can be drawn again
alone, so the program's first weights never need a copy."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Spec = Dict[str, Tuple[Sequence[int], str]]


def draw(specs: Spec, name: str, seed: int, std: float,
         device) -> torch.Tensor:
    shape, init = specs[name]
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init != "normal":
        raise ValueError(f"unknown initialiser {init!r} of {name}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 4096 + sorted(specs).index(name))
    return torch.randn(shape, generator=gen, device=device) * std


def draw_all(specs: Spec, seed: int, std: float,
             device) -> Dict[str, torch.Tensor]:
    return {n: draw(specs, n, seed, std, device) for n in sorted(specs)}

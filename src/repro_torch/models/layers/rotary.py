"""Rotary position embeddings (RoPE), half-split convention."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, each f32[..., head_dim/2], for int positions."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(theta, exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2),
    any leading position shape that broadcasts against x's: (seq,
    head_dim/2) for one row of positions shared by the batch, (b, 1,
    head_dim/2) for each row's decode position. Rotates in f32 and
    returns x's dtype."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)

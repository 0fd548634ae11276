"""Learning-rate schedules: linear warm-up (Goyal et al.), then constant,
linear or cosine decay. Computed with float32 tensor ops on the CPU, so
the value is the JAX package's f32 value, cosine included."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def lr_at(cfg: OptimizerConfig, step: int) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 0-dim CPU tensor."""
    f32 = torch.float32
    step_t = torch.tensor(float(step), dtype=f32)
    base = torch.tensor(cfg.learning_rate, dtype=f32)
    warm = torch.tensor(float(max(cfg.warmup_steps, 1)), dtype=f32)
    warmup_frac = torch.minimum((step_t + 1.0) / warm,
                                torch.tensor(1.0, dtype=f32))
    if cfg.schedule == "constant":
        return base * warmup_frac
    total = torch.tensor(float(max(cfg.total_steps, 1)), dtype=f32)
    progress = torch.clamp((step_t - warm)
                           / torch.clamp(total - warm, min=1.0), 0.0, 1.0)
    if cfg.schedule == "warmup_linear":
        return base * warmup_frac * (1.0 - progress)
    if cfg.schedule == "warmup_cosine":
        pi = torch.tensor(math.pi, dtype=f32)
        return base * warmup_frac * 0.5 * (1.0 + torch.cos(pi * progress))
    raise ValueError(f"unknown schedule {cfg.schedule}")

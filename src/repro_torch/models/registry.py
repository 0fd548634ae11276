"""Model registry: family -> model class."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig) -> TransformerLM:
    if cfg.family == "dense":
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported to repro_torch yet; see "
        "ROADMAP.md queue A")

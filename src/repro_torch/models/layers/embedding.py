"""Token embeddings and the LM head."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.params import ParamSpec, normal_init


def spec(cfg) -> Dict[str, ParamSpec]:
    return {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                normal_init(0.02))}


def head_spec(cfg) -> Dict[str, ParamSpec]:
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), normal_init(0.02))}


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens: (B, S) integer -> (B, S, D) in ``compute_dtype``."""
    return params["tokens"][tokens].to(compute_dtype)


def logits(head_params: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, V)."""
    return x @ head_params["w"]

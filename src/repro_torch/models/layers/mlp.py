"""SwiGLU feed-forward block. Weights are stored (in, out) and used as
``x @ W``, the JAX package's layout."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, fan_in_init


def spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported to repro_torch "
            "yet; see ROADMAP.md queue A")
    d, f = cfg.d_model, cfg.d_ff
    return {"wi_gate": ParamSpec((d, f), fan_in_init(0)),
            "wi_up": ParamSpec((d, f), fan_in_init(0)),
            "wo": ParamSpec((f, d), fan_in_init(0))}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    return (F.silu(gate) * up) @ params["wo"]

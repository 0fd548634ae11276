"""RMSNorm. Normalises in f32 and returns the input dtype."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.params import ParamSpec, ones_init


def spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    return {"scale": ParamSpec((cfg.d_model,), ones_init)}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)

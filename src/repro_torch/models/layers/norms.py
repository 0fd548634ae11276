"""Normalization layers: RMSNorm, LayerNorm, the non-parametric LayerNorm
of OLMo (no scale, no bias), and qwen3's per-head RMS QK-norm. Each
normalises in f32 and returns the input dtype. The scales and biases
carry the JAX package's logical axis ('embed'), which no rule table puts
on a mesh: they are replicated on every model rank."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.params import ParamSpec, ones_init, zeros_init


def spec(cfg, kind: Optional[str] = None) -> Dict[str, ParamSpec]:
    kind = kind or cfg.norm
    d = cfg.d_model
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), ones_init)}
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), ones_init),
                "bias": ParamSpec((d,), ("embed",), zeros_init)}
    if kind == "nonparametric_ln":  # OLMo: LN without affine parameters
        return {}
    raise ValueError(f"unknown norm {kind}")


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor, kind: str,
          eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind in ("layernorm", "nonparametric_ln"):
        mean = torch.mean(xf, dim=-1, keepdim=True)
        # The population variance, as jnp.var computes it.
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind}")
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """QK-norm (qwen3): RMS-normalise the per-head feature dim."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

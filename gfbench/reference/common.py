"""What the decoder-only references share, in plain PyTorch: LayerNorm,
rotary embeddings, causal attention, the cross-entropy, and the matrix
product every layer goes through.

Everything is computed in float32, its products with TF32 off
(``exact``) or, where a cell's file says so, in TF32 (``tf32``: ten bits
of each operand's mantissa against bfloat16's seven, float32 sums). The
control
computes the same functions one precision below the bfloat16 that the
configurations state: every product's operands rounded to float8 e4m3
with a per-tensor scale (``fp8``), the gradient passed straight through
the rounding. Nothing here imports the measured program.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


MATMULS = ("exact", "tf32")


def set_matmul(name: str = "exact") -> None:
    """float32 products in float32 (``exact``: TF32 off for matmuls and
    cuDNN) or in TF32 (``tf32``)."""
    if name not in MATMULS:
        raise ValueError(f"unknown reference matmul precision {name!r}")
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448), back in x's dtype; the gradient passes
    through unchanged."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


class Precision:
    """How the references multiply: ``einsum(spec, a, b)``."""

    def __init__(self, name: str):
        if name not in ("exact", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def einsum(self, spec: str, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            a, b = _fp8_round(a), _fp8_round(b)
        return torch.einsum(spec, a, b)


def layer_norm(x: torch.Tensor, eps: float, scale=None,
               bias=None) -> torch.Tensor:
    """LayerNorm over the last axis with the population variance; no
    affine parameters when ``scale`` is None."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * scale + bias
    return y


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding of x (b, s, h, d) at positions 0..s-1,
    the half-split form (GPT-NeoX's ``rotate_half``)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: Precision) -> torch.Tensor:
    """softmax(q k^T / sqrt(d), causal) v; q, k, v (b, s, h, d)."""
    s = q.shape[1]
    scores = prec.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    return prec.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position (and codebook)."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1).long())


def layer_stack(w: Dict[str, torch.Tensor], layer: int) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s weights: every ``layers/...`` stack indexed."""
    return {name[len("layers/"):]: t[layer] for name, t in w.items()
            if name.startswith("layers/")}


def run_layers(x: torch.Tensor, w: Dict[str, torch.Tensor], layers: int,
               block: Callable) -> torch.Tensor:
    """x through ``block(x, layer_weights)`` for each layer, each layer's
    activations recomputed in the backward pass so that a whole row fits
    in float32."""
    for i in range(layers):
        lw = layer_stack(w, i)
        x = torch.utils.checkpoint.checkpoint(
            lambda h, lw=lw: block(h, lw), x, use_reentrant=False)
    return x

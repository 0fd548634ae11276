"""OLMo (arXiv:2402.00838), the plain reference: a decoder-only
transformer with the non-parametric LayerNorm (no scale, no bias) before
attention, before the MLP and before the head; multi-head causal
attention with rotary embeddings on the whole head and no biases; a
SwiGLU MLP (silu(x W_gate) * (x W_up)) W_out; the input embedding tied to
the output head. Weights are stored (in, out) and stacked over the
layers; their names are the benchmark's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from gfbench.reference import common


def param_shapes(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each weight's shape and initialiser ('normal': N(0, init std))."""
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    n, f = cfg["num_hidden_layers"], cfg["intermediate_size"]
    return {"embed/tokens": ((v, d), "normal"),
            "layers/attn/wq": ((n, d, d), "normal"),
            "layers/attn/wk": ((n, d, d), "normal"),
            "layers/attn/wv": ((n, d, d), "normal"),
            "layers/attn/wo": ((n, d, d), "normal"),
            "layers/ffn/wi_gate": ((n, d, f), "normal"),
            "layers/ffn/wi_up": ((n, d, f), "normal"),
            "layers/ffn/wo": ((n, f, d), "normal")}


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, cfg: Dict,
         prec: common.Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of rows ``tokens`` (b, s)."""
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    mm = prec.einsum

    def block(x, lw):
        b, s, d = x.shape
        h = common.layer_norm(x, eps)
        q, k, v = (mm("bsd,de->bse", h, lw[f"attn/{n}"]).view(
            b, s, heads, -1) for n in ("wq", "wk", "wv"))
        q, k = common.rope(q, cfg["rope_theta"]), common.rope(
            k, cfg["rope_theta"])
        a = common.causal_attention(q, k, v, prec).reshape(b, s, d)
        x = x + mm("bsd,de->bse", a, lw["attn/wo"])
        h = common.layer_norm(x, eps)
        gate = mm("bsd,df->bsf", h, lw["ffn/wi_gate"])
        up = mm("bsd,df->bsf", h, lw["ffn/wi_up"])
        return x + mm("bsf,fd->bsd", F.silu(gate) * up, lw["ffn/wo"])

    x = w["embed/tokens"][tokens]
    x = common.run_layers(x, w, cfg["num_hidden_layers"], block)
    x = common.layer_norm(x, eps)
    logits = mm("bsd,vd->bsv", x, w["embed/tokens"])
    return common.cross_entropy(logits, labels)

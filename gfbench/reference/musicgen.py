"""MusicGen's decoder (arXiv:2306.05284), the plain reference over K
codec token streams: the K codebook embeddings of a position summed;
pre-norm layers with LayerNorm (scale and bias) before attention and
before the MLP; multi-head causal self-attention without biases; an MLP
gelu(x W_in) W_out without biases; a final LayerNorm and one head a
codebook. As the configuration runs it (its file lists each departure
from the published model): rotary embeddings on the whole head in place
of the sinusoidal positions, GELU's tanh form, no text cross-attention,
and a ``tokens`` table that no position reads. Weights are stored
(in, out) and stacked over the layers; their names are the benchmark's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from gfbench.reference import common


def param_shapes(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each weight's shape and initialiser ('normal': N(0, init std),
    'ones', 'zeros')."""
    v, d, k = cfg["vocab_size"], cfg["hidden_size"], cfg["num_codebooks"]
    n, f = cfg["num_hidden_layers"], cfg["ffn_dim"]
    return {"embed/codebooks": ((k, v, d), "normal"),
            "embed/tokens": ((v, d), "normal"),
            "final_norm/bias": ((d,), "zeros"),
            "final_norm/scale": ((d,), "ones"),
            "head/w": ((k, d, v), "normal"),
            "layers/attn/wq": ((n, d, d), "normal"),
            "layers/attn/wk": ((n, d, d), "normal"),
            "layers/attn/wv": ((n, d, d), "normal"),
            "layers/attn/wo": ((n, d, d), "normal"),
            "layers/attn_norm/bias": ((n, d), "zeros"),
            "layers/attn_norm/scale": ((n, d), "ones"),
            "layers/ffn/wi": ((n, d, f), "normal"),
            "layers/ffn/wo": ((n, f, d), "normal"),
            "layers/mlp_norm/bias": ((n, d), "zeros"),
            "layers/mlp_norm/scale": ((n, d), "ones")}


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, cfg: Dict,
         prec: common.Precision) -> torch.Tensor:
    """Mean cross-entropy over every position and codebook of rows
    ``tokens`` (b, s, K)."""
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    mm = prec.einsum

    def block(x, lw):
        b, s, d = x.shape
        h = common.layer_norm(x, eps, lw["attn_norm/scale"],
                              lw["attn_norm/bias"])
        q, k, v = (mm("bsd,de->bse", h, lw[f"attn/{n}"]).view(
            b, s, heads, -1) for n in ("wq", "wk", "wv"))
        q, k = common.rope(q, cfg["rope_theta"]), common.rope(
            k, cfg["rope_theta"])
        a = common.causal_attention(q, k, v, prec).reshape(b, s, d)
        x = x + mm("bsd,de->bse", a, lw["attn/wo"])
        h = common.layer_norm(x, eps, lw["mlp_norm/scale"],
                              lw["mlp_norm/bias"])
        act = F.gelu(mm("bsd,df->bsf", h, lw["ffn/wi"]), approximate="tanh")
        return x + mm("bsf,fd->bsd", act, lw["ffn/wo"])

    table = w["embed/codebooks"]
    x = sum(table[i][tokens[..., i]] for i in range(table.shape[0]))
    x = common.run_layers(x, w, cfg["num_hidden_layers"], block)
    x = common.layer_norm(x, eps, w["final_norm/scale"], w["final_norm/bias"])
    logits = mm("bsd,kdv->bskv", x, w["head/w"])
    return common.cross_entropy(logits, labels)

"""Trinity (Arcee's afmoe, hf:arcee-ai/Trinity-Mini), the plain reference:
a decoder-only transformer whose layers differ.

* The embedding times sqrt(hidden_size) (``mup_enabled``); an untied
  head after a final RMSNorm with a gain.
* Sandwich norms, four RMSNorms with gains a layer (eps ``rms_norm_eps``):
  x += post_attn_norm(attn(in_norm(x))); x += post_mlp_norm(ffn(pre_mlp_
  norm(x))).
* Gated grouped-query attention: q, k, v projections, Q and K RMS-normed
  per head (gains of head_dim), RoPE (the half-split form) on the
  ``sliding_attention`` layers only (NoPE on the full ones), causal
  attention, sliding layers seeing the ``sliding_window`` latest keys
  (query i sees key j when 0 <= i - j < window); the heads' output times
  sigmoid(h W_g), then W_o.
* The first ``num_dense_layers`` FFNs are SwiGLU of
  ``intermediate_size``; the others are MoE layers: scores
  sigmoid(h W_r) over ``num_experts``, the top ``num_experts_per_tok``
  chosen on the scores plus an expert bias (held at 0, its initial value)
  with ties to the lower expert, gates the chosen scores over their sum
  (+1e-20) times ``route_scale``, each routed SwiGLU expert of
  ``moe_intermediate_size`` weighted by its gate, plus the shared
  experts' output for every token. This chip holds experts 0 ..
  ``num_experts_held`` - 1: a slot routed to another expert adds
  nothing here (that expert's chip computes it).

The four equations the config does not state (gate, sandwich norms,
per-head QK norm with NoPE on full layers, the mup embedding scale) are
the model type's published modeling code's. Weights are stored (in, out),
the attention and norms stacked over every layer, the dense FFNs over the
dense layers, the MoE weights over the MoE layers; names are the
benchmark's. Each layer runs under a checkpoint; attention runs a block
of queries at a time, each under its own checkpoint, over the keys its
mask keeps; the router's product is in float64 (exact against the TF32
of the other products), the experts a loop over the held ones. Nothing
here imports the measured program.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gfbench.reference import common

QUERY_BLOCK = 1024


def _sizes(cfg: Dict):
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return (d, heads, cfg["num_key_value_heads"],
            cfg.get("head_dim") or d // heads)


def param_shapes(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each weight's shape and initialiser ('normal': N(0, init std),
    'ones')."""
    d, h, kv, hd = _sizes(cfg)
    n, nd = cfg["num_hidden_layers"], cfg["num_dense_layers"]
    nm, v = n - nd, cfg["vocab_size"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = fe * cfg["num_shared_experts"]
    e, held = cfg["num_experts"], cfg["num_experts_held"]
    out = {"embed/tokens": ((v, d), "normal"),
           "final_norm/scale": ((d,), "ones"),
           "head/w": ((d, v), "normal"),
           "layers/attn/wq": ((n, d, h * hd), "normal"),
           "layers/attn/wk": ((n, d, kv * hd), "normal"),
           "layers/attn/wv": ((n, d, kv * hd), "normal"),
           "layers/attn/wg": ((n, d, h * hd), "normal"),
           "layers/attn/wo": ((n, h * hd, d), "normal"),
           "layers/attn/q_norm": ((n, hd), "ones"),
           "layers/attn/k_norm": ((n, hd), "ones"),
           "layers/dense_ffn/wi_gate": ((nd, d, f), "normal"),
           "layers/dense_ffn/wi_up": ((nd, d, f), "normal"),
           "layers/dense_ffn/wo": ((nd, f, d), "normal"),
           "layers/ffn/router": ((nm, d, e), "normal"),
           "layers/ffn/wi_gate": ((nm, held, d, fe), "normal"),
           "layers/ffn/wi_up": ((nm, held, d, fe), "normal"),
           "layers/ffn/wo": ((nm, held, fe, d), "normal")}
    if fs:
        out.update({"layers/ffn/shared/wi_gate": ((nm, d, fs), "normal"),
                    "layers/ffn/shared/wi_up": ((nm, d, fs), "normal"),
                    "layers/ffn/shared/wo": ((nm, fs, d), "normal")})
    for norm in ("attn_norm", "attn_post_norm", "mlp_norm", "mlp_post_norm"):
        out[f"layers/{norm}/scale"] = ((n, d), "ones")
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _keys(q0: int, q1: int, window: int) -> Tuple[int, int]:
    """The keys a block of queries q0 .. q1 - 1 sees."""
    return (max(0, q0 - window + 1) if window else 0), q1


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, prec: common.Precision) -> torch.Tensor:
    """Causal attention of q, k, v (b, s, h, hd) (a sliding ``window``
    when nonzero), a block of queries at a time under its own
    checkpoint, over the keys the block's mask keeps."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5

    def block(q0, q1, qb, kb, vb):
        k0 = _keys(q0, q1, window)[0]
        sc = prec.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        i = torch.arange(q0, q1, device=q.device)[:, None]
        j = torch.arange(k0, q1, device=q.device)[None, :]
        keep = (i >= j) & ((i - j < window) if window else True)
        sc = sc.masked_fill(~keep, float("-inf"))
        return prec.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), vb)

    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        k0, k1 = _keys(q0, q1, window)
        outs.append(torch.utils.checkpoint.checkpoint(
            lambda qb, kb, vb, q0=q0, q1=q1: block(q0, q1, qb, kb, vb),
            q[:, q0:q1], k[:, k0:k1], v[:, k0:k1], use_reentrant=False))
    return torch.cat(outs, dim=1)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           out: torch.Tensor, prec: common.Precision) -> torch.Tensor:
    """(silu(x W_gate) * (x W_up)) W_out of tokens x (t, d)."""
    mm = prec.einsum
    return mm("tf,fd->td", F.silu(mm("td,df->tf", x, gate))
              * mm("td,df->tf", x, up), out)


def route(h: torch.Tensor, router: torch.Tensor, cfg: Dict,
          prec: common.Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (t, k), expert indices (t, k)) of tokens h (t, d)."""
    logits = prec.einsum("td,de->te", h.double(), router.double()).float()
    scores = torch.sigmoid(logits)
    bias = torch.zeros(scores.shape[-1], device=h.device)
    idx = torch.sort(scores.detach() + bias, dim=-1, descending=True,
                     stable=True).indices[:, :cfg["num_experts_per_tok"]]
    g = torch.gather(scores, -1, idx)
    return g / (g.sum(dim=-1, keepdim=True) + 1e-20) * cfg["route_scale"], \
        idx


def moe(h: torch.Tensor, lw: Dict[str, torch.Tensor], cfg: Dict,
        prec: common.Precision) -> torch.Tensor:
    """The MoE FFN on tokens h (t, d): the held experts' gated outputs
    and the shared experts'."""
    gates, idx = route(h, lw["ffn/router"], cfg, prec)
    out = torch.zeros_like(h)
    for e in range(lw["ffn/wi_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if not len(tok):
            continue
        y = swiglu(h[tok], lw["ffn/wi_gate"][e], lw["ffn/wi_up"][e],
                   lw["ffn/wo"][e], prec)
        out = out.index_add(0, tok, y * gates[tok, slot, None])
    if "ffn/shared/wi_gate" in lw:
        out = out + swiglu(h, lw["ffn/shared/wi_gate"],
                           lw["ffn/shared/wi_up"], lw["ffn/shared/wo"], prec)
    return out


def _layer_weights(w: Dict[str, torch.Tensor], i: int,
                   cfg: Dict) -> Dict[str, torch.Tensor]:
    """Layer i's weights: each stack indexed by the layer's place in it
    (the dense FFNs' under ``dense_ffn/``, the MoE's under ``ffn/``)."""
    nd = cfg["num_dense_layers"]
    out = {}
    for name, t in w.items():
        if not name.startswith("layers/"):
            continue
        key = name[len("layers/"):]
        if key.startswith("dense_ffn/"):
            if i < nd:
                out[key] = t[i]
        elif key.startswith("ffn/"):
            if i >= nd:
                out[key] = t[i - nd]
        else:
            out[key] = t[i]
    return out


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, cfg: Dict,
         prec: common.Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of rows ``tokens`` (b, s)."""
    d, heads, kv, hd = _sizes(cfg)
    eps, nd = cfg["rms_norm_eps"], cfg["num_dense_layers"]
    mm = prec.einsum

    def block(x, lw, i):
        b, s, _ = x.shape
        sliding = cfg["layer_types"][i] == "sliding_attention"
        h = rms_norm(x, lw["attn_norm/scale"], eps)
        q = mm("bsd,de->bse", h, lw["attn/wq"]).view(b, s, heads, hd)
        k = mm("bsd,de->bse", h, lw["attn/wk"]).view(b, s, kv, hd)
        v = mm("bsd,de->bse", h, lw["attn/wv"]).view(b, s, kv, hd)
        q = rms_norm(q, lw["attn/q_norm"], eps)
        k = rms_norm(k, lw["attn/k_norm"], eps)
        if sliding:
            q = common.rope(q, cfg["rope_theta"])
            k = common.rope(k, cfg["rope_theta"])
        k = k.repeat_interleave(heads // kv, dim=2)
        v = v.repeat_interleave(heads // kv, dim=2)
        a = attention(q, k, v, cfg["sliding_window"] if sliding else 0,
                      prec).reshape(b, s, heads * hd)
        a = a * torch.sigmoid(mm("bsd,de->bse", h, lw["attn/wg"]))
        x = x + rms_norm(mm("bse,ed->bsd", a, lw["attn/wo"]),
                         lw["attn_post_norm/scale"], eps)
        h = rms_norm(x, lw["mlp_norm/scale"], eps).reshape(b * s, d)
        if i < nd:
            f = swiglu(h, lw["dense_ffn/wi_gate"], lw["dense_ffn/wi_up"],
                       lw["dense_ffn/wo"], prec)
        else:
            f = moe(h, lw, cfg, prec)
        return x + rms_norm(f.view(b, s, d), lw["mlp_post_norm/scale"], eps)

    x = w["embed/tokens"][tokens]
    if cfg["mup_enabled"]:
        x = x * d ** 0.5
    for i in range(cfg["num_hidden_layers"]):
        lw = _layer_weights(w, i, cfg)
        x = torch.utils.checkpoint.checkpoint(
            lambda h, lw=lw, i=i: block(h, lw, i), x, use_reentrant=False)
    x = rms_norm(x, w["final_norm/scale"], eps)
    return common.cross_entropy(mm("bsd,dv->bsv", x, w["head/w"]), labels)

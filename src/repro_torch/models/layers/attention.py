"""Grouped-query causal attention with rotary embeddings — the training
path with full (materialised-score) attention. The blockwise path the JAX
package takes beyond ``attn_chunk`` tokens is not ported yet and raises."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import rotary
from repro_torch.models.params import ParamSpec, fan_in_init

NEG_INF = -1e30


def spec(cfg) -> Dict[str, ParamSpec]:
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm is not ported to repro_torch "
                                  "yet; see ROADMAP.md queue A")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {"wq": ParamSpec((d, h * hd), fan_in_init(0)),
            "wk": ParamSpec((d, kv * hd), fan_in_init(0)),
            "wv": ParamSpec((d, kv * hd), fan_in_init(0)),
            "wo": ParamSpec((h * hd, d), fan_in_init(0))}


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal attention with materialised scores; softmax in f32.
    q, k, v: (b, s, h, hd) -> (b, s, h, hd)."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    s = s.masked_fill(qpos < kpos, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def apply_train(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                attn_chunk: int = 0) -> torch.Tensor:
    """Full-sequence causal attention for training."""
    b, s, _ = x.shape
    if attn_chunk and s > attn_chunk:
        raise NotImplementedError(
            f"sequence {s} > attn_chunk {attn_chunk} takes blockwise "
            "attention, which is not ported to repro_torch yet; see "
            "ROADMAP.md queue A (pass attn_chunk=0 for full attention)")
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).view(b, s, h, hd)
    k = (x @ params["wk"]).view(b, s, kv, hd)
    v = (x @ params["wv"]).view(b, s, kv, hd)
    cos, sin = rotary.rope_tables(torch.arange(s, device=x.device), hd,
                                  cfg.rope_theta)
    q = rotary.apply_rope(q, cos, sin)
    k = rotary.apply_rope(k, cos, sin)
    groups = h // kv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    out = full_attention(q, k, v).reshape(b, s, h * hd)
    return out @ params["wo"]

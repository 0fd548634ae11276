"""Grouped-query causal attention with rotary embeddings and optional
QK-norm, the training path: full attention (materialised scores) for short
sequences, blockwise (online-softmax) attention beyond ``attn_chunk``
tokens.

Blockwise attention never materialises the (S, S) score matrix: it walks
the KV blocks of each query block with a running (max, sum, acc), the
FlashAttention recurrence written in PyTorch ops, as the JAX package
writes it in ``jnp``. ``causal_skip`` walks only the lower-triangle block
pairs (i >= j) of a causal square grid, half the attention FLOPs of the
masked full grid. Under autograd each block keeps its scores and
probabilities for the backward pass (as JAX's scan does under
``jax.checkpoint``), so training memory is not below full attention's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import norms, rotary
from repro_torch.models.params import ParamSpec, fan_in_init, ones_init

NEG_INF = -1e30


def spec(cfg) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": ParamSpec((d, h * hd), fan_in_init(0)),
         "wk": ParamSpec((d, kv * hd), fan_in_init(0)),
         "wv": ParamSpec((d, kv * hd), fan_in_init(0)),
         "wo": ParamSpec((h * hd, d), fan_in_init(0))}
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), ones_init)
        p["k_norm"] = ParamSpec((hd,), ones_init)
    return p


def _project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (b, s, h, hd), k and v (b, s, kv, hd); QK-norm before RoPE."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).view(b, s, h, hd)
    k = (x @ params["wk"]).view(b, s, kv, hd)
    v = (x @ params["wv"]).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = norms.rms_head_norm(params["q_norm"], q)
        k = norms.rms_head_norm(params["k_norm"], k)
    cos, sin = rotary.rope_tables(torch.arange(s, device=x.device), hd,
                                  cfg.rope_theta)
    return rotary.apply_rope(q, cos, sin), rotary.apply_rope(k, cos, sin), v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scores (b, h, q, k) of the product in the inputs' dtype."""
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5


def _causal_mask(q0: int, nq: int, k0: int, nk: int,
                 device: torch.device) -> torch.Tensor:
    """(nq, nk) bool: query position q0 + r sees key position k0 + c."""
    qpos = q0 + torch.arange(nq, device=device)[:, None]
    kpos = k0 + torch.arange(nk, device=device)[None, :]
    return qpos >= kpos


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool) -> torch.Tensor:
    """Attention with materialised scores; softmax in f32.
    q, k, v: (b, s, h, hd) -> (b, s, h, hd)."""
    s = _scores(q, k)
    if causal:
        s = s.masked_fill(~_causal_mask(0, q.shape[1], 0, k.shape[1],
                                        q.device), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block_attend(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
                  m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step. q (b, cq, h, hd), kb and vb (b, ck, h, hd),
    m and l (b, h, cq) f32, acc (b, cq, h, hd). The probabilities meet v
    in q's dtype; acc keeps its own."""
    s = _scores(q, kb)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vb)
    acc_new = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) + pv
    return m_new, l_new, acc_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, chunk_q: int, chunk_k: int,
                        causal_skip: bool = True) -> torch.Tensor:
    """FlashAttention-style blockwise attention in PyTorch ops, the JAX
    package's recurrence and dtypes. q (b, sq, h, hd), k and v
    (b, sk, h, hd), sq and sk multiples of their chunks.

    ``causal_skip`` on a causal square grid: only the pairs (i, j <= i),
    in the JAX scan's order (i-major), each query block's accumulator
    kept in f32 and cast to q's dtype around every step. Otherwise the
    full grid, masked when causal, the accumulator in q's dtype."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq % chunk_q or sk % chunk_k:
        raise ValueError(f"sequence ({sq}, {sk}) is not a multiple of the "
                         f"chunks ({chunk_q}, {chunk_k})")
    nq, nk = sq // chunk_q, sk // chunk_k
    skip = causal and causal_skip and sq == sk and chunk_q == chunk_k
    outs = []
    for i in range(nq):
        qi = q[:, i * chunk_q:(i + 1) * chunk_q]
        m = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, chunk_q, h, hd),
                          dtype=torch.float32 if skip else q.dtype,
                          device=q.device)
        for j in range(i + 1 if skip else nk):
            mask = _causal_mask(i * chunk_q, chunk_q, j * chunk_k, chunk_k,
                                q.device) if causal else None
            kj = k[:, j * chunk_k:(j + 1) * chunk_k]
            vj = v[:, j * chunk_k:(j + 1) * chunk_k]
            if skip:
                m, l, acc = _block_attend(qi, kj, vj, m, l, acc.to(q.dtype),
                                          mask)
                acc = acc.float()
            else:
                m, l, acc = _block_attend(qi, kj, vj, m, l, acc, mask)
        out = acc.float() / l.transpose(1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def _pick_chunk(s: int, target: int, floor: int = 64) -> int:
    """Largest divisor of s that is <= target (0 if none >= floor)."""
    c = min(target, s)
    while c >= floor:
        if s % c == 0:
            return c
        c -= 1
    return 0


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, attn_chunk: int = 0,
           causal_skip: bool = True) -> torch.Tensor:
    """Full attention up to ``attn_chunk`` tokens, blockwise beyond it;
    full attention again when either length has no divisor >= 64 at or
    below ``attn_chunk``."""
    sq, sk = q.shape[1], k.shape[1]
    if attn_chunk and max(sq, sk) > attn_chunk:
        cq = _pick_chunk(sq, attn_chunk)
        ck = _pick_chunk(sk, attn_chunk)
        if cq and ck:
            return blockwise_attention(q, k, v, causal=causal, chunk_q=cq,
                                       chunk_k=ck, causal_skip=causal_skip)
    return full_attention(q, k, v, causal=causal)


def apply_train(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                attn_chunk: int = 0, causal_skip: bool = True
                ) -> torch.Tensor:
    """Full-sequence causal attention for training."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    groups = cfg.num_heads // cfg.num_kv_heads
    out = attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                 causal=True, attn_chunk=attn_chunk, causal_skip=causal_skip)
    return out.reshape(b, s, -1) @ params["wo"]

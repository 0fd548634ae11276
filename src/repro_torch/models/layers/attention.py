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

Those forms run on CPU tensors, where they are the JAX package's bits.
On CUDA tensors ``attend`` takes the flash-attention kernels
(``kernels/flash_attention.py``) for every causal self-attention, in
training and in prefill: the scores and probabilities stay on chip,
forward and backward, so ``attn_chunk`` has nothing to cut there.

Serving: a KV cache (``KVCache``), ``apply_prefill`` over the prompt
(causal attention, the prompt's keys and values written into the cache)
and ``apply_decode`` of one token against the whole cache, naive or
``split_combine``, as the JAX package writes them. The cache's index is
a device tensor, and every write lands at a device offset: a decode
step reads nothing back to the host. Under a model axis the serve rules
place the cache (``cache_logical_axes``, ``serve_layout``): a rank holds
its KV heads at every position ('kv_heads' sharded) or every KV head at
its block of positions ('kv_seq' sharded), and a decode step against the
latter combines the ranks' online-softmax partials over the model group
(``_decode_seq``); no form gathers the cache.

The weights carry the JAX package's logical axes ('embed', 'qkv');
``parallel.sharding`` alone maps them to a mesh. When the rules shard
'qkv' over a model axis (``parallel.model_axis``) the block is
Megatron's: ``wq``, ``wk`` and ``wv`` column-parallel (each rank holds
a contiguous block of the query heads and of the KV heads; when the KV
heads split whole, a rank's query heads map onto its own KV heads, and
when they do not, as the rules allow where they leave 'kv_heads'
replicated, every rank gathers the k and v projections and its query
heads read their global KV groups), attention on the local heads
(QK-norm and rotary are per head; the replicated QK-norm scales'
gradients are summed over the model group), ``wo`` row-parallel, its
partial sum all-reduced over the model group. The head counts come from
the weights' shapes, so the same code runs on the whole model and on
one rank's shard.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import norms, rotary
from repro_torch.models.params import (ParamSpec, fan_in_init, ones_init,
                                      zeros_of)

NEG_INF = -1e30


class KVCache(NamedTuple):
    """A layer's KV cache; stacked, a model's (a leading layer axis on
    every field). The serving functions update k, v and index in place
    and return the same tensors: the cache passed in is consumed, as
    the JAX package's serve step donates it (``donate_argnums``)."""
    k: torch.Tensor      # (B, S_max, KV, hd), the cache dtype
    v: torch.Tensor      # (B, S_max, KV, hd)
    index: torch.Tensor  # 0-dim int32: positions written so far


def spec(cfg) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": ParamSpec((d, h * hd), ("embed", "qkv"), fan_in_init(0)),
         "wk": ParamSpec((d, kv * hd), ("embed", "qkv"), fan_in_init(0)),
         "wv": ParamSpec((d, kv * hd), ("embed", "qkv"), fan_in_init(0)),
         "wo": ParamSpec((h * hd, d), ("qkv", "embed"), fan_in_init(0))}
    if cfg.attn_gate:
        p["wg"] = ParamSpec((d, h * hd), ("embed", "qkv"), fan_in_init(0))
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), ones_init)
        p["k_norm"] = ParamSpec((hd,), (None,), ones_init)
    return p


def _project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                 positions: Optional[torch.Tensor] = None, kv_gather=None,
                 rope: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (b, s, h, hd), k and v (b, s, kv, hd); QK-norm before RoPE at
    ``positions`` (None: 0..s-1 for every row; a decode step passes its
    (b, 1) device positions; ``rope`` False: no positions, NoPE).
    ``kv_gather`` (a model axis's ``gather``) joins the ranks' blocks of
    the k and v projections first: k and v then have every KV head."""
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if kv_gather is not None:
        k, v = kv_gather(torch.stack([k, v]), -1).unbind(0)
    return _heads(params, q, k, v, cfg, positions, rope)


def _heads(params: Dict[str, torch.Tensor], q: torch.Tensor,
           k: torch.Tensor, v: torch.Tensor, cfg,
           positions: Optional[torch.Tensor] = None, rope: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projections (b, s, n * hd) as heads (b, s, n, hd), q and k
    QK-normed and, with ``rope``, rotated at ``positions`` (None:
    0..s-1)."""
    b, s, _ = q.shape
    hd = cfg.resolved_head_dim
    q = q.view(b, s, -1, hd)
    k = k.view(b, s, -1, hd)
    v = v.view(b, s, -1, hd)
    if cfg.qk_norm:
        q = norms.rms_head_norm(params["q_norm"], q, cfg.norm_eps)
        k = norms.rms_head_norm(params["k_norm"], k, cfg.norm_eps)
    if not rope:
        return q, k, v
    if positions is None:
        positions = torch.arange(s, device=q.device)
    cos, sin = rotary.rope_tables(positions, hd, cfg.rope_theta)
    return rotary.apply_rope(q, cos, sin), rotary.apply_rope(k, cos, sin), v


def _kv_of_local_heads(k: torch.Tensor, v: torch.Tensor, heads: int, cfg,
                       model_axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every KV head's k and v (b, s, KV, hd) -> the KV head each of this
    rank's ``heads`` query heads reads (global query head j reads KV
    head j // (H / KV))."""
    first = model_axis.index * heads
    kv_of = torch.div(torch.arange(first, first + heads, device=k.device),
                      cfg.num_heads // cfg.num_kv_heads,
                      rounding_mode="floor")
    return k[:, :, kv_of], v[:, :, kv_of]


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scores (b, h, q, k) of the product in the inputs' dtype."""
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5


def _causal_mask(q0: int, nq: int, k0: int, nk: int,
                 device: torch.device, window: int = 0) -> torch.Tensor:
    """(nq, nk) bool: query position q0 + r sees key position k0 + c
    (with a ``window`` W, only the W latest: 0 <= i - j < W)."""
    qpos = q0 + torch.arange(nq, device=device)[:, None]
    kpos = k0 + torch.arange(nk, device=device)[None, :]
    if window:
        return (qpos >= kpos) & (qpos - kpos < window)
    return qpos >= kpos


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0) -> torch.Tensor:
    """Attention with materialised scores; softmax in f32.
    q, k, v: (b, s, h, hd) -> (b, s, h, hd). ``window`` (causal only):
    sliding-window attention over the ``window`` latest keys."""
    s = _scores(q, k)
    if causal:
        s = s.masked_fill(~_causal_mask(0, q.shape[1], 0, k.shape[1],
                                        q.device, window), NEG_INF)
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
                        causal_skip: bool = True,
                        window: int = 0) -> torch.Tensor:
    """FlashAttention-style blockwise attention in PyTorch ops, the JAX
    package's recurrence and dtypes. q (b, sq, h, hd), k and v
    (b, sk, h, hd), sq and sk multiples of their chunks.

    ``causal_skip`` on a causal square grid: only the pairs (i, j <= i),
    in the JAX scan's order (i-major), each query block's accumulator
    kept in f32 and cast to q's dtype around every step. Otherwise the
    full grid, masked when causal, the accumulator in q's dtype. A
    ``window`` masks every block to the ``window`` latest keys (a block
    pair with nothing kept still runs; every row keeps its own key)."""
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
                                q.device, window) if causal else None
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
           causal_skip: bool = True, window: int = 0) -> torch.Tensor:
    """On CUDA tensors, causal self-attention (``sq == sk``) through the
    flash-attention kernels (``kernels.ops.flash_attention``), whatever
    ``attn_chunk``: they never build the score grid it cuts. Anything
    else on CUDA raises (every caller is causal and square). ``window``
    W > 0: query i sees key j when 0 <= i - j < W.

    On CPU tensors: full attention up to ``attn_chunk`` tokens, blockwise
    beyond it; full attention again when either length has no divisor
    >= 64 at or below ``attn_chunk``."""
    sq, sk = q.shape[1], k.shape[1]
    if q.is_cuda:
        if not causal or sq != sk:
            raise ValueError(f"attention on CUDA takes causal "
                             f"self-attention (the flash-attention "
                             f"kernels), got causal={causal}, {sq} queries "
                             f"and {sk} keys")
        return ops.flash_attention(q, k, v, window)
    if attn_chunk and max(sq, sk) > attn_chunk:
        cq = _pick_chunk(sq, attn_chunk)
        ck = _pick_chunk(sk, attn_chunk)
        if cq and ck:
            return blockwise_attention(q, k, v, causal=causal, chunk_q=cq,
                                       chunk_k=ck, causal_skip=causal_skip,
                                       window=window)
    return full_attention(q, k, v, causal=causal, window=window)


def apply_train(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                attn_chunk: int = 0, causal_skip: bool = True,
                model_axis=None, layer: int = 0) -> torch.Tensor:
    """Full-sequence causal attention for training; on the local heads
    under a model axis that shards 'qkv'. ``layer`` picks the layer's
    kind (``cfg.window``, ``cfg.rope``); with ``cfg.attn_gate`` the
    heads' output is gated, ``(o * sigmoid(x W_g)) W_o``."""
    tp = model_axis is not None and model_axis.sharded("qkv")
    gather = None
    if tp:
        x = model_axis.copy_in(x)
        # The QK-norm scales are replicated but meet only this rank's
        # heads: their gradient is the sum over the model ranks.
        params = {k: model_axis.copy_in(v) if k.endswith("_norm") else v
                  for k, v in params.items()}
        # KV heads that do not split whole over the ranks (the rules
        # leave 'kv_heads' replicated then): every rank gathers them all.
        if cfg.num_kv_heads % model_axis.size:
            gather = model_axis.gather
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, kv_gather=gather,
                           rope=cfg.rope(layer))
    if gather is not None:
        k, v = _kv_of_local_heads(k, v, q.shape[2], cfg, model_axis)
    groups = q.shape[2] // k.shape[2]
    out = attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                 causal=True, attn_chunk=attn_chunk, causal_skip=causal_skip,
                 window=cfg.window(layer)).reshape(b, s, -1)
    if cfg.attn_gate:
        out = out * torch.sigmoid(x @ params["wg"])
    y = out @ params["wo"]
    return model_axis.reduce_out(y) if tp else y


def abstract_cache(cfg, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> KVCache:
    """The cache's fields as (shape, dtype) pairs; nothing allocated."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(k=((batch, max_len, kv, hd), dtype),
                   v=((batch, max_len, kv, hd), dtype),
                   index=((), torch.int32))


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None
               ) -> KVCache:
    """An empty cache (zeros, index 0) on ``device`` (CUDA unless
    given)."""
    from repro_torch import resolve_device
    return zeros_of(abstract_cache(cfg, batch, max_len, dtype),
                    resolve_device(device))


def cache_logical_axes() -> KVCache:
    """The cache's logical axes, the JAX package's: the batch on
    'serve_batch', the positions on 'kv_seq', the KV heads on
    'kv_heads'."""
    return KVCache(k=("serve_batch", "kv_seq", "kv_heads", None),
                   v=("serve_batch", "kv_seq", "kv_heads", None), index=())


def serve_layout(model_axis) -> str:
    """How a rank holds the cache and runs attention under the serve
    rules of ``model_axis`` (None: one device):

    * 'whole': every KV head at every position, attention whole (one
      device, or rules that shard neither the projections nor the
      cache);
    * 'heads': 'kv_heads' and 'qkv' sharded: the rank's KV heads at
      every position, attention on its heads, ``wo`` row-parallel;
    * 'seq': 'kv_seq' sharded: every KV head at the rank's block of
      ``S_max / M`` positions; the rank's query heads when 'qkv' is
      sharded, every head when it is not.
    """
    if model_axis is None or model_axis.size == 1:
        return "whole"
    seq, heads = model_axis.sharded("kv_seq"), model_axis.sharded("kv_heads")
    qkv = model_axis.sharded("qkv")
    if seq and not heads:
        return "seq"
    if heads and qkv and not seq:
        return "heads"
    if not (seq or heads or qkv):
        return "whole"
    raise ValueError(
        f"no serving form for the rules kv_seq={model_axis.rules.get('kv_seq')!r}, "
        f"kv_heads={model_axis.rules.get('kv_heads')!r}, "
        f"qkv={model_axis.rules.get('qkv')!r}: one mesh axis shards one "
        f"cache dimension, and sharded KV heads need sharded projections")


def _write(buf: torch.Tensor, new: torch.Tensor, index: torch.Tensor
           ) -> None:
    """Write new (b, s, ...) into buf (b, S, ...) at positions index ..
    index + s - 1, in place. The start is clamped to [0, S - s] on the
    device, as ``lax.dynamic_update_slice`` clamps it: past the end the
    write lands on the last s positions."""
    s = new.shape[1]
    start = torch.clamp(index, 0, buf.shape[1] - s).long()
    buf.index_copy_(1, start + torch.arange(s, device=buf.device),
                    new.to(buf.dtype))


def _write_block(buf: torch.Tensor, new: torch.Tensor, index: torch.Tensor,
                 model_axis) -> None:
    """``_write`` into a cache whose positions are split over the model
    ranks: ``buf`` (b, n, ...) holds global positions r n .. r n + n - 1
    of rank r. The start is clamped as the whole cache's (to [0, M n -
    s]), and each rank writes the tokens that land in its block: a
    window of min(s, n) distinct positions, each taking its token where
    the rank owns it and keeping its value where it does not (a
    where-select on the device, no host read)."""
    s, n = new.shape[1], buf.shape[1]
    start = torch.clamp(index, 0, n * model_axis.size - s).long()
    w = min(s, n)
    off = model_axis.index * n
    pos = torch.clamp(start - off, 0, n - w) \
        + torch.arange(w, device=buf.device)
    src = pos + off - start
    owned = ((src >= 0) & (src < s)).view((1, w) + (1,) * (buf.dim() - 2))
    vals = new.to(buf.dtype).index_select(1, src.clamp(0, s - 1))
    buf.index_copy_(1, pos, torch.where(owned, vals,
                                        buf.index_select(1, pos)))


def _write_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
              layout: str, model_axis) -> None:
    if layout == "seq":
        _write_block(cache.k, k, cache.index, model_axis)
        _write_block(cache.v, v, cache.index, model_axis)
    else:
        _write(cache.k, k, cache.index)
        _write(cache.v, v, cache.index)


def apply_prefill(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                  cache: KVCache, *, attn_chunk: int = 0, model_axis=None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt x (b, s, d), at positions 0..s-1
    whatever the cache holds (as in JAX), blockwise with ``causal_skip``
    beyond ``attn_chunk``; its keys and values are written into the
    cache at ``cache.index`` and the index advances by s. Returns (y,
    the cache passed in, updated in place).

    Under ``model_axis`` (its serve rules; ``serve_layout``): 'heads'
    attends on the rank's heads and writes its KV heads; 'seq' gathers
    the k and v projections when 'qkv' is sharded (an activation, every
    KV head), attends on the rank's query heads, and writes each
    position into the rank that holds it. ``wo`` is row-parallel when
    'qkv' is sharded, its partial sum all-reduced."""
    layout = serve_layout(model_axis)
    tp = layout != "whole" and model_axis.sharded("qkv")
    b, s, _ = x.shape
    gather = model_axis.gather if layout == "seq" and tp else None
    q, k, v = _project_qkv(params, x, cfg, kv_gather=gather)
    kq, vq = (k, v) if gather is None else \
        _kv_of_local_heads(k, v, q.shape[2], cfg, model_axis)
    groups = q.shape[2] // kq.shape[2]
    out = attend(q, _repeat_kv(kq, groups), _repeat_kv(vq, groups),
                 causal=True, attn_chunk=attn_chunk)
    _write_kv(cache, k, v, layout, model_axis)
    cache.index.add_(s)
    y = out.reshape(b, s, -1) @ params["wo"]
    return (model_axis.reduce_out(y) if tp else y), cache


def _partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax partials of q (b, 1, H, hd) over the cache
    positions k, v (b, n, KV, hd) where ``valid`` (n,): the f32 max m
    (b, H), the sum of exponentials l (b, H) and the numerator (b, H,
    hd), the probabilities meeting v in q's dtype."""
    groups = q.shape[2] // k.shape[2]
    s = _scores(q, _repeat_kv(k, groups)).masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                         # (b,H,1,1)
    p = torch.exp(s - m)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype),
                       _repeat_kv(v, groups)).float()
    return m[:, :, 0, 0], p.sum(dim=-1)[:, :, 0], num[:, 0]


def _combine(model_axis, m: torch.Tensor, l: torch.Tensor,
             num: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The model group's partials joined: one all-reduce gathers every
    rank's (m, l, num), then each rank rescales them to the largest max
    and sums them in rank order, so every rank holds the same (m, l,
    num) of the whole cache."""
    b, h, hd = num.shape
    mine = torch.cat([m, l, num.reshape(b, h * hd)], dim=-1)
    every = model_axis.gather(mine[None], 0)          # (M, b, H (hd + 2))
    ms, ls = every[..., :h], every[..., h:2 * h]
    nums = every[..., 2 * h:].reshape(-1, b, h, hd)
    top = ms.amax(dim=0)
    w = torch.exp(ms - top)
    return top, (w * ls).sum(dim=0), (w[..., None] * nums).sum(dim=0)


def _decode_seq(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                cache: KVCache, split_combine: bool, model_axis
                ) -> torch.Tensor:
    """One decode step against a cache split over the model ranks by
    position ('seq'). With 'qkv' sharded one all-reduce joins the
    ranks' q, k and v projections (every query head's q, (b, 1, H, hd),
    is small); each rank scores every head over its positions and the
    partials are combined over the group (``_combine``); the rank keeps
    its heads' output for the row-parallel ``wo``. Naive: the token is
    written first and scored with the cache; ``split_combine``: the old
    positions are combined, then merged with the token's own score, as
    JAX's online-softmax combine, and the token written after."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    tp = model_axis.sharded("qkv")
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if tp:
        nq, nk = q.shape[-1], k.shape[-1]
        every = model_axis.gather(torch.cat([q, k, v], dim=-1), -1) \
            .view(b, 1, model_axis.size, nq + 2 * nk)
        q, k, v = (every[..., a:z].reshape(b, 1, -1) for a, z in (
            (0, nq), (nq, nq + nk), (nq + nk, nq + 2 * nk)))
    q, k, v = _heads(params, q, k, v, cfg, cache.index.expand(b, 1))
    n = cache.k.shape[1]
    kpos = model_axis.index * n + torch.arange(n, device=x.device)
    if split_combine:
        m, l, num = _combine(model_axis, *_partials(
            q, cache.k, cache.v, kpos < cache.index))
        groups = q.shape[2] // k.shape[2]
        s_new = torch.einsum("bqhd,bqhd->bh", q, _repeat_kv(k, groups)) \
            .float() * hd ** -0.5
        top = torch.maximum(m, s_new)
        w_old, w_new = torch.exp(m - top), torch.exp(s_new - top)
        num = num * w_old[..., None] + w_new[..., None] \
            * _repeat_kv(v, groups)[:, 0].float()
        out = num / (l * w_old + w_new)[..., None]
        _write_kv(cache, k, v, "seq", model_axis)
    else:
        _write_kv(cache, k, v, "seq", model_axis)
        m, l, num = _combine(model_axis, *_partials(
            q, cache.k, cache.v, kpos <= cache.index))
        out = num / l[..., None]
    out = out.to(q.dtype)                                   # (b, H, hd)
    if tp:
        h = out.shape[1] // model_axis.size
        out = out[:, model_axis.index * h:(model_axis.index + 1) * h]
    cache.index.add_(1)
    y = out.reshape(b, 1, -1) @ params["wo"]
    return model_axis.reduce_out(y) if tp else y


def apply_decode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                 cache: KVCache, *, split_combine: bool = False,
                 model_axis=None) -> Tuple[torch.Tensor, KVCache]:
    """One token x (b, 1, d) at position ``cache.index`` against the
    whole cache (every ``S_max`` position scored, those past the index
    masked), the cache repeated to the query heads. Returns (y, the
    cache passed in, with the token's keys and values written and the
    index advanced by one, in place).

    Naive: write the token into the cache, then attend over it.
    ``split_combine``: attend over the old cache and the fresh token
    apart and merge them with an online-softmax combine, then write (in
    JAX the attention then never consumes the updated cache, which keeps
    a sequence-sharded cache shard-local).

    Under ``model_axis`` (its serve rules; ``serve_layout``): 'heads'
    runs on the rank's heads and its KV heads, ``wo`` row-parallel;
    'seq' is ``_decode_seq``'s cross-rank combine. No form gathers the
    cache or a weight."""
    layout = serve_layout(model_axis)
    if layout == "seq":
        return _decode_seq(params, x, cfg, cache, split_combine,
                           model_axis), cache
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, x, cfg,
                           positions=cache.index.expand(b, 1))
    groups = q.shape[2] // k.shape[2]
    kpos = torch.arange(cache.k.shape[1], device=x.device)
    out = None
    if split_combine:
        vf = _repeat_kv(cache.v, groups)
        s_old = _scores(q, _repeat_kv(cache.k, groups))     # (B,H,1,S)
        s_old = s_old.masked_fill(~(kpos < cache.index), NEG_INF)
        s_new = torch.einsum("bqhd,bqhd->bhq", q, _repeat_kv(k, groups)) \
            .float()[..., None] * hd ** -0.5                 # (B,H,1,1)
        m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
        p_old = torch.exp(s_old - m)
        p_new = torch.exp(s_new - m)
        num = torch.einsum("bhqk,bkhd->bqhd", p_old.to(q.dtype), vf) \
            .float() + p_new.transpose(1, 2).float() \
            * _repeat_kv(v, groups).float()
        den = p_old.sum(dim=-1) + p_new[..., 0]              # (B,H,1)
        out = (num / den.transpose(1, 2)[..., None]).to(q.dtype)
    _write(cache.k, k, cache.index)
    _write(cache.v, v, cache.index)
    if out is None:
        vf = _repeat_kv(cache.v, groups)
        s = _scores(q, _repeat_kv(cache.k, groups))
        s = s.masked_fill(~(kpos <= cache.index), NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    cache.index.add_(1)
    y = out.reshape(b, 1, -1) @ params["wo"]
    return (model_axis.reduce_out(y) if layout == "heads" else y), cache

"""Mamba-2 (SSD) block, zamba2's backbone mixer: the training path.

The chunked SSD matmul form (Mamba-2 paper §6): inside a chunk of Q
steps the recurrence becomes a masked (Q, Q) product a head, like
attention, and a (B, H, head_dim, d_state) f32 state carries from chunk
to chunk. No per-step (B, L, H, hd, ds) outer products are materialised.
JAX's ``lax.scan`` runs the whole chunk body (``_ssd_chunk``) a chunk;
the port computes every chunk's products at once and loops over the
chunks only for the state's two-op carry: the same formulas in a layer's
launches instead of a chunk's (eager PyTorch pays the host for each
launch; XLA compiles the body once).

The JAX package writes the block in ``jnp`` and ``lax``, with no Pallas
kernel; the port writes it in PyTorch ops.

Decode (``apply_decode``): one token a step, the scalar-decay state
update against a ``Mamba2State`` (the conv window of x, B and C in the
cache dtype, the f32 (B, H, head_dim, d_state) state), in place.

Each weight carries the JAX package's logical axes ('embed', 'dinner',
'conv'); only ``parallel.sharding`` maps them to a mesh. Under a model
axis whose rules shard 'dinner' (``parallel.model_axis``) a rank runs a
contiguous block of the heads and of the inner channels
(``local_params``): B and C, shared by every head, are computed whole
on every rank (their gradients, partial on each, are summed through the
gathered weights'); the gated norm's mean of squares is summed over the
group (``all_sum``), the reduce GSPMD inserts in the JAX package's
sharded program; ``out_proj`` is row-parallel. Serving makes the
rank's view of the weights once (``serve_local``), so a serve step
gathers no weight. The decode state keeps the JAX package's layout
(``state_logical_axes``): the SSM state on the rank's heads, the conv
window split into contiguous blocks of the concatenated [x | B | C]
channels, which are not the rank's working set; a decode step joins the
whole window with the token's conv input in one all-reduce
(``_window``) and keeps its block of the next.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.layers.mamba import (SCAN_CHUNK, _causal_conv,
                                             decode_conv, softplus)
from repro_torch.models.params import (ParamSpec, fan_in_init, full_init,
                                       normal_init, ones_init, zeros_init,
                                       zeros_of)


class Mamba2State(NamedTuple):
    """A layer's decode state (stacked: a model's). ``apply_decode``
    updates both fields in place and returns the same tensors."""
    conv: torch.Tensor  # (B, d_conv - 1, d_inner + 2 d_state)
    ssm: torch.Tensor   # (B, H, head_dim, d_state) f32


def dims(cfg) -> Tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state, d_conv)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    hd = cfg.ssm.head_dim
    n_heads = cfg.ssm.n_heads or d_inner // hd
    return d_inner, n_heads, hd, cfg.ssm.d_state, cfg.ssm.d_conv


def _a_log_init(gen, shape):
    """log(A) for A evenly spaced over [1, 16], one a head, in f64 and
    rounded once to f32."""
    a = torch.linspace(1.0, 16.0, shape[0], dtype=torch.float64,
                       device=gen.device)
    return torch.log(a).float()


def spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, h, _, ds, dc = dims(cfg)
    conv_ch = d_inner + 2 * ds  # x, B and C all pass the causal conv
    return {
        # order: [z (d_inner), x (d_inner), B (ds), C (ds), dt (h)]
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * ds + h),
                             ("embed", "dinner"), fan_in_init(0)),
        "conv_w": ParamSpec((dc, conv_ch), ("conv", "dinner"),
                            normal_init(0.02)),
        "conv_b": ParamSpec((conv_ch,), ("dinner",), zeros_init),
        "A_log": ParamSpec((h,), (None,), _a_log_init),
        "D": ParamSpec((h,), (None,), ones_init),
        "dt_bias": ParamSpec((h,), (None,), full_init(-4.6)),
        "norm_scale": ParamSpec((d_inner,), ("dinner",), ones_init),
        "out_proj": ParamSpec((d_inner, d), ("dinner", "embed"),
                              fan_in_init(0)),
    }


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6, model_axis=None) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before out_proj, in f32. On a rank's
    block of the inner channels (``model_axis``) the mean of squares is
    over every channel: the block's sum of squares summed over the
    group, over the whole width."""
    yf = y.float() * F.silu(z.float())
    if model_axis is None:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    else:
        var = model_axis.all_sum(torch.sum(torch.square(yf), dim=-1,
                                           keepdim=True)) \
            / (yf.shape[-1] * model_axis.size)
    return yf * torch.rsqrt(var + eps) * scale.float()


def _ssd_chunks(xh: torch.Tensor, bq: torch.Tensor, cq: torch.Tensor,
                loga: torch.Tensor) -> torch.Tensor:
    """The SSD over N chunks of Q steps (matmul form), from a zero state.

    xh:   (B, N, Q, H, hd)  Δ-scaled inputs, f32
    bq:   (B, N, Q, ds)     input projections (shared by the heads)
    cq:   (B, N, Q, ds)     output projections
    loga: (B, N, Q, H)      per-step log decay (Δ·(−exp(A_log)); ≤ 0)
    Returns y (B, N, Q, H, hd).

    Chunk by chunk the formulas of JAX's ``_ssd_chunk``: the intra-chunk
    products, the incoming state's contribution, and the state update
    h_out = exp(ℓ_Q) h0 + Σ_s exp(ℓ_Q−ℓ_s) xh_s ⊗ B_s. The mask is
    applied after ``exp``, as in JAX: above the diagonal ``exp`` sees
    ℓ_t − ℓ_s > 0, and a large Δ overflows it there, which gives NaN
    gradients (0 · inf) in both packages.
    """
    q = xh.shape[2]
    cum = torch.cumsum(loga, dim=2)                    # (B,N,Q,H) ℓ_t
    # intra-chunk: y_t += Σ_{s<=t} exp(ℓ_t−ℓ_s)·(C_t·B_s)·xh_s
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,N,Qt,Qs,H)
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(causal[:, :, None], torch.exp(rel), 0.0)
    cb = torch.einsum("bntd,bnsd->bnts", cq, bq)       # (B,N,Qt,Qs)
    y = torch.einsum("bntsh,bnshd->bnthd", cb[..., None] * decay, xh)
    # each chunk's own contribution to the state it passes on
    tail = cum[:, :, -1:, :]
    local = torch.einsum("bnqh,bnqhp,bnqd->bnhpd", torch.exp(tail - cum),
                         xh, bq)
    carry = torch.exp(tail[:, :, 0])[..., None, None]  # (B,N,H,1,1)
    h, h_in = torch.zeros_like(local[:, 0]), []
    for c in range(local.shape[1]):
        h_in.append(h)
        h = h * carry[:, c] + local[:, c]
    # inter-chunk: the incoming state's contribution
    return y + torch.einsum("bntd,bnhpd,bnth->bnthp", cq,
                            torch.stack(h_in, dim=1), torch.exp(cum))


def local_params(params: Dict[str, torch.Tensor], cfg, model_axis
                 ) -> Dict[str, torch.Tensor]:
    """This rank's view of a block's weights (one layer's, or a stack's:
    the channels are the last dimension) for its block of the heads and
    inner channels: ``in_proj`` and the conv gathered (their contiguous
    blocks cut across their fused parts) and the rank's columns of each
    part taken, B's and C's whole; its heads' entries of the replicated
    per-head A_log, D and Δ bias, whose gradients are then summed over
    the group; ``norm_scale`` and ``out_proj`` as they are (their blocks
    are the rank's channels). Serving makes this view once
    (``serve_local``); training makes it a step, under autograd."""
    d_inner, h, _, ds, _ = dims(cfg)
    ch, hs = model_axis.block(d_inner), model_axis.block(h)
    w = model_axis.gather(params["in_proj"], -1)
    bc = slice(2 * d_inner, 2 * d_inner + 2 * ds)
    p = dict(params)
    p["in_proj"] = torch.cat(
        [w[..., ch], w[..., d_inner + ch.start:d_inner + ch.stop],
         w[..., bc], w[..., 2 * d_inner + 2 * ds + hs.start:2 * d_inner
                       + 2 * ds + hs.stop]], dim=-1)
    conv_w = model_axis.gather(params["conv_w"], -1)
    conv_b = model_axis.gather(params["conv_b"], -1)
    p["conv_w"] = torch.cat([conv_w[..., ch], conv_w[..., d_inner:]], dim=-1)
    p["conv_b"] = torch.cat([conv_b[..., ch], conv_b[..., d_inner:]], dim=-1)
    for k in ("A_log", "D", "dt_bias"):
        p[k] = model_axis.copy_in(params[k])[..., hs]
    return p


def serve_local(params: Dict[str, torch.Tensor], cfg, model_axis
                ) -> Dict[str, torch.Tensor]:
    """The serving weights of a block (or a stack of them) under a
    model axis that shards 'dinner': ``local_params``, made once, so a
    serve step gathers no weight; the weights as they are otherwise."""
    if model_axis is None or not model_axis.sharded("dinner"):
        return params
    with torch.no_grad():
        return local_params(params, cfg, model_axis)


def apply_train(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                scan_chunk: int = SCAN_CHUNK, model_axis=None,
                prepared: bool = False) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D), in x's dtype; the SSD and the gated
    norm in f32. Under a model axis that shards 'dinner', on this rank's
    block of the heads (see the module docstring); ``prepared``:
    ``params`` are already ``serve_local``'s (a prefill's)."""
    b, n, _ = x.shape
    d_inner, h, hd, ds, _ = dims(cfg)
    tp = model_axis is not None and model_axis.sharded("dinner")
    if tp:
        x = model_axis.copy_in(x)
        if not prepared:
            params = local_params(params, cfg, model_axis)
        d_inner, h = d_inner // model_axis.size, h // model_axis.size
    z, xs, b_raw, c_raw, dt = torch.split(
        x @ params["in_proj"], [d_inner, d_inner, ds, ds, h], dim=-1)
    q = min(scan_chunk, n)
    assert n % q == 0, (n, q)
    chunks = (b, n // q, q)
    conv_out = F.silu(_causal_conv(torch.cat([xs, b_raw, c_raw], dim=-1),
                                   params["conv_w"], params["conv_b"]))
    xq = conv_out[..., :d_inner].reshape(*chunks, h, hd).float()
    bq = conv_out[..., d_inner:d_inner + ds].reshape(*chunks, ds).float()
    cq = conv_out[..., d_inner + ds:].reshape(*chunks, ds).float()
    delta = softplus(dt.float() + params["dt_bias"]).reshape(*chunks, h)
    a = -torch.exp(params["A_log"].float())            # (H,)
    y = _ssd_chunks(xq * delta[..., None], bq, cq, delta * a)
    y = y + params["D"].float()[:, None] * xq
    y = _gated_norm(y.reshape(b, n, d_inner), z, params["norm_scale"],
                    model_axis=model_axis if tp else None)
    out = y.to(x.dtype) @ params["out_proj"]
    return model_axis.reduce_out(out) if tp else out


def abstract_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16
                   ) -> Mamba2State:
    """The state's fields as (shape, dtype) pairs; nothing allocated."""
    d_inner, h, hd, ds, dc = dims(cfg)
    return Mamba2State(conv=((batch, dc - 1, d_inner + 2 * ds), dtype),
                       ssm=((batch, h, hd, ds), torch.float32))


def init_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None
               ) -> Mamba2State:
    """A zero state on ``device`` (CUDA unless given)."""
    from repro_torch import resolve_device
    return zeros_of(abstract_state(cfg, batch, dtype), resolve_device(device))


def state_logical_axes() -> Mamba2State:
    """The state's logical axes, the JAX package's: the conv window on
    'dinner' (over the concatenated [x | B | C] channels), the SSM state
    on 'heads'."""
    return Mamba2State(conv=("serve_batch", None, "dinner"),
                       ssm=("serve_batch", "heads", None, "state"))


def _window(state: Mamba2State, conv_in: torch.Tensor, cfg, model_axis
            ) -> torch.Tensor:
    """The whole conv window (B, d_conv, d_inner + 2 d_state) of a
    decode step under a model axis, in one all-reduce: each rank puts
    its block of the held window (the first d_conv - 1 rows) and its
    channels of the token's x (the last row; rank 0 adds B and C) into
    zeros, and the group sums them, each value with zeros only."""
    d_inner, _, _, ds, dc = dims(cfg)
    b, c = conv_in.shape[0], state.conv.shape[-1]
    ch = model_axis.block(d_inner)
    full = state.conv.new_zeros((b, dc, d_inner + 2 * ds))
    full[:, :dc - 1, model_axis.index * c:(model_axis.index + 1) * c] = \
        state.conv
    last = conv_in[:, 0].to(full.dtype)
    full[:, dc - 1, ch] = last[:, :ch.stop - ch.start]
    if model_axis.index == 0:
        full[:, dc - 1, d_inner:] = last[:, ch.stop - ch.start:]
    return model_axis.all_reduce_(full)


def apply_decode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                 state: Mamba2State, model_axis=None
                 ) -> Tuple[torch.Tensor, Mamba2State]:
    """One token x (B, 1, D) -> (y (B, 1, D), the state passed in, its
    window shifted and its SSM state advanced, in place). Under a model
    axis that shards 'dinner' ``params`` are ``serve_local``'s and the
    state the JAX package's blocks: the whole window is joined
    (``_window``), the rank convolves its x channels with B and C, runs
    its heads, sums the gated norm's squares over the group and
    ``out_proj`` is row-parallel (three all-reduces)."""
    b = x.shape[0]
    d_inner, h, hd, ds, _ = dims(cfg)
    tp = model_axis is not None and model_axis.sharded("dinner")
    if tp:
        d_inner, h = d_inner // model_axis.size, h // model_axis.size
    z, xs, b_raw, c_raw, dt = torch.split(
        x @ params["in_proj"], [d_inner, d_inner, ds, ds, h], dim=-1)
    conv_in = torch.cat([xs, b_raw, c_raw], dim=-1)
    if tp:
        full = _window(state, conv_in, cfg, model_axis)
        ch = model_axis.block(d_inner * model_axis.size)
        window = torch.cat([full[..., ch],
                            full[..., d_inner * model_axis.size:]], dim=-1)
        c = state.conv.shape[-1]
        state.conv.copy_(full[:, 1:, model_axis.index * c:
                              (model_axis.index + 1) * c])
    else:
        window = torch.cat([state.conv, conv_in.to(state.conv.dtype)],
                           dim=1)
        state.conv.copy_(window[:, 1:])
    conv_out = F.silu(decode_conv(window, params["conv_w"],
                                  params["conv_b"]))
    xq = conv_out[:, 0, :d_inner].reshape(b, h, hd).float()
    bq = conv_out[:, 0, d_inner:d_inner + ds].float()
    cq = conv_out[:, 0, d_inner + ds:].float()
    delta = softplus(dt[:, 0].float() + params["dt_bias"])    # (B,H)
    decay = torch.exp(delta * -torch.exp(params["A_log"].float()))
    h_new = state.ssm * decay[..., None, None] \
        + (xq * delta[..., None])[..., None] * bq[:, None, None, :]
    y = torch.einsum("bhpd,bd->bhp", h_new, cq)
    y = (y + params["D"].float()[:, None] * xq).reshape(b, 1, d_inner)
    y = _gated_norm(y, z, params["norm_scale"],
                    model_axis=model_axis if tp else None).to(x.dtype)
    state.ssm.copy_(h_new)
    out = y @ params["out_proj"]
    return (model_axis.reduce_out(out) if tp else out), state

"""Mamba-1 selective-state-space block (falcon-mamba), the training path.

An outer loop over sequence chunks of ``scan_chunk`` positions carries
the (B, d_inner, d_state) f32 recurrent state from chunk to chunk, as
the JAX package's ``lax.scan`` does. Inside a chunk a doubling
(Hillis-Steele) scan computes the recurrence h_t = a_t h_{t-1} + u_t in
log2(chunk) levels of whole-tensor products; JAX's
``lax.associative_scan`` associates the same sums otherwise, so the two
differ by about one f32 rounding a level. Chunking bounds the
materialised (B, chunk, d_inner, d_state) tensors; under autograd each
chunk keeps its levels for the backward pass, as JAX's scan keeps its
residuals. What does not depend on the state (the conv, whose window the
JAX scan carries across chunk edges, and the Δ/B/C projections) runs
over the whole sequence before the loop: the same values, a chunk's
launches fewer.

The scan is elementwise work (no matmul): the JAX package writes it in
``jnp`` and ``lax``, with no Pallas kernel, and the port in PyTorch ops.

Decode (``apply_decode``): one token a step against a ``MambaState``,
the conv's trailing window (in the cache dtype) and the f32 SSM state,
both O(1) in the sequence length and updated in place.

Each weight carries the JAX package's logical axes ('embed', 'dinner',
'conv', 'state'); only ``parallel.sharding`` maps them to a mesh. Under a
model axis whose rules shard 'dinner' (``parallel.model_axis``) a rank
runs its contiguous block of the inner channels: the conv, Δ's
projection and bias, A, D and the scan are per channel and stay local;
``x_proj`` contracts over the channels, so its partial product is summed
over the group (``all_sum``) before Δ, B and C; ``out_proj`` is
row-parallel, its partial sum all-reduced. ``in_proj``'s 2·d_inner
columns hold x's then z's: a rank's contiguous block of them (the JAX
package's shard) is not its channels' columns, so the weight is
gathered (``gather``; backward its gradient summed and the block kept)
and the rank multiplies by its channels' x and z columns
(``local_params``). Serving makes that view once (``serve_local``), so
a prefill or decode step under the model axis gathers no weight; the
decode state's blocks are the rank's channels (``state_logical_axes``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.params import (ParamSpec, fan_in_init, full_init,
                                       normal_init, ones_init, zeros_init,
                                       zeros_of)


# Positions a chunk of the training paths' outer loops (Mamba-1's and
# Mamba-2's).
SCAN_CHUNK = 128


class MambaState(NamedTuple):
    """A layer's decode state (stacked: a model's). ``apply_decode``
    updates both fields in place and returns the same tensors."""
    conv: torch.Tensor  # (B, d_conv - 1, d_inner): the trailing window
    ssm: torch.Tensor   # (B, d_inner, d_state) f32


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, dt_rank, d_state, d_conv)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return d_inner, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def _a_log_init(gen, shape):
    """S4D-real init: A = -[1..d_state] per channel, stored as log(-A).
    The logarithm is taken in f64 and rounded once to f32."""
    d_inner, d_state = shape
    a = torch.arange(1, d_state + 1, dtype=torch.float64, device=gen.device)
    return torch.log(a).float()[None, :].expand(d_inner, d_state).clone()


def spec(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = dims(cfg)
    return {
        "in_proj": ParamSpec((d, 2 * d_inner), ("embed", "dinner"),
                             fan_in_init(0)),
        "conv_w": ParamSpec((d_conv, d_inner), ("conv", "dinner"),
                            normal_init(0.02)),
        "conv_b": ParamSpec((d_inner,), ("dinner",), zeros_init),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * d_state),
                            ("dinner", None), fan_in_init(0)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "dinner"),
                             normal_init(1.0 / math.sqrt(16))),
        "dt_bias": ParamSpec((d_inner,), ("dinner",), full_init(-4.6)),
        "A_log": ParamSpec((d_inner, d_state), ("dinner", "state"),
                           _a_log_init),
        "D": ParamSpec((d_inner,), ("dinner",), ones_init),
        "out_proj": ParamSpec((d_inner, d), ("dinner", "embed"),
                              fan_in_init(0)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d from zeros before the sequence. x: (B, L,
    C); w: (K, C). The K taps are added one at a time into a zero tensor
    of x's dtype, then the bias: one rounding a tap in bf16, JAX's order
    (not ``F.conv1d``'s f32 sum)."""
    k, n = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + n, :] * w[i]
    return out + b


def _ssm_params(params: Dict[str, torch.Tensor], xz: torch.Tensor, cfg,
                model_axis=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The input-dependent half: Δ (f32, softplus of the bias-shifted
    projection computed in the input dtype), B and C (f32). ``x_proj``
    contracts over the inner channels: on a rank's block of them
    (``model_axis``) its product is a partial sum, summed over the
    group."""
    _, dt_rank, d_state, _ = dims(cfg)
    dbc = xz @ params["x_proj"]
    if model_axis is not None:
        dbc = model_axis.all_sum(dbc)
    dt = dbc[..., :dt_rank] @ params["dt_proj"] + params["dt_bias"]
    delta = softplus(dt.float())
    b_mat = dbc[..., dt_rank:dt_rank + d_state].float()
    c_mat = dbc[..., dt_rank + d_state:].float()
    return delta, b_mat, c_mat


def _scan_chunk(x_f32: torch.Tensor, delta: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk. x_f32, delta: (B, Q, di); b, c: (B, Q, ds); a: (di, ds);
    h0: (B, di, ds). Returns y (B, Q, di) and the last state."""
    a_bar = torch.exp(delta[..., None] * a)                 # (B,Q,di,ds)
    u = (delta * x_f32)[..., None] * b_mat[:, :, None, :]   # (B,Q,di,ds)
    # Fold the incoming state into the first step: h_1 = A_1 h0 + Bx_1.
    u[:, 0] += a_bar[:, 0] * h0
    q, k = u.shape[1], 1
    while k < q:
        # Step t absorbs step t-k: (a_{t-k} a_t, a_t u_{t-k} + u_t).
        u = torch.cat([u[:, :k], a_bar[:, k:] * u[:, :-k] + u[:, k:]], dim=1)
        if 2 * k < q:
            a_bar = torch.cat([a_bar[:, :k], a_bar[:, k:] * a_bar[:, :-k]],
                              dim=1)
        k *= 2
    y = torch.sum(u * c_mat[:, :, None, :], dim=-1)
    return y, u[:, -1]


def local_params(params: Dict[str, torch.Tensor], cfg, model_axis
                 ) -> Dict[str, torch.Tensor]:
    """This rank's view of a block's weights (one layer's, or a stack's:
    the channels are the last dimension) for its block of the inner
    channels: ``in_proj`` gathered (its contiguous block cuts across x
    and z) and the rank's x and z columns taken; the rest as they are
    (their blocks are the rank's channels). Serving makes this view once
    (``serve_local``); training makes it a step, under autograd."""
    d_inner = dims(cfg)[0]
    full, mine = model_axis.gather(params["in_proj"], -1), \
        model_axis.block(d_inner)
    p = dict(params)
    p["in_proj"] = torch.cat(
        [full[..., mine], full[..., d_inner + mine.start:d_inner
                               + mine.stop]], dim=-1)
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
    """x: (B, L, D) -> (B, L, D), in x's dtype; the scan in f32. Under a
    model axis that shards 'dinner', on this rank's block of the inner
    channels (see the module docstring); ``prepared``: ``params`` are
    already ``serve_local``'s (a prefill's)."""
    b, n, _ = x.shape
    d_inner, _, d_state, _ = dims(cfg)
    tp = model_axis is not None and model_axis.sharded("dinner")
    if tp:
        x = model_axis.copy_in(x)
        if not prepared:
            params = local_params(params, cfg, model_axis)
        d_inner //= model_axis.size
    w = params["in_proj"]
    xs, z = (x @ w).chunk(2, dim=-1)
    q = min(scan_chunk, n)
    assert n % q == 0, (n, q)
    x_act = F.silu(_causal_conv(xs, params["conv_w"], params["conv_b"]))
    delta, b_mat, c_mat = _ssm_params(params, x_act, cfg,
                                      model_axis if tp else None)
    xf = x_act.float()
    a = -torch.exp(params["A_log"].float())
    h = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(n // q):
        s = slice(c * q, (c + 1) * q)
        y, h = _scan_chunk(xf[:, s], delta[:, s], b_mat[:, s], c_mat[:, s],
                           a, h)
        ys.append(y)
    y = torch.cat(ys, dim=1) + params["D"].float() * xf
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return model_axis.reduce_out(out) if tp else out


def abstract_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16
                   ) -> MambaState:
    """The state's fields as (shape, dtype) pairs; nothing allocated."""
    d_inner, _, d_state, d_conv = dims(cfg)
    return MambaState(conv=((batch, d_conv - 1, d_inner), dtype),
                      ssm=((batch, d_inner, d_state), torch.float32))


def init_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None
               ) -> MambaState:
    """A zero state on ``device`` (CUDA unless given)."""
    from repro_torch import resolve_device
    return zeros_of(abstract_state(cfg, batch, dtype), resolve_device(device))


def state_logical_axes() -> MambaState:
    """The state's logical axes, the JAX package's: the conv window and
    the SSM state on the inner channels ('dinner'), so a rank's blocks
    are its channels'."""
    return MambaState(conv=("serve_batch", None, "dinner"),
                      ssm=("serve_batch", "dinner", "state"))


def decode_conv(window: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The causal conv at one position: window (B, K, C) times w (K, C)
    summed over the K taps in the window's dtype, plus the bias; (B, 1,
    C). JAX's ``jnp.sum`` of the bf16 products, which XLA accumulates in
    f32 and rounds once, as ``torch.sum`` does."""
    return torch.sum(window * w.to(window.dtype), dim=1, keepdim=True) + b


def apply_decode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                 state: MambaState, model_axis=None
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One token x (B, 1, D) -> (y (B, 1, D), the state passed in, its
    window shifted by the token and its SSM state advanced, in place).
    Under a model axis that shards 'dinner' ``params`` are
    ``serve_local``'s and the state the rank's channels': ``x_proj``'s
    partial product is summed over the group and ``out_proj`` is
    row-parallel (two all-reduces)."""
    _, _, d_state, _ = dims(cfg)
    tp = model_axis is not None and model_axis.sharded("dinner")
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)         # (B,1,di)
    window = torch.cat([state.conv, xs.to(state.conv.dtype)], dim=1)
    xa = F.silu(decode_conv(window, params["conv_w"], params["conv_b"]))
    delta, b_mat, c_mat = _ssm_params(params, xa, cfg,
                                      model_axis if tp else None)
    a = -torch.exp(params["A_log"].float())
    a_bar = torch.exp(delta[:, 0, :, None] * a)               # (B,di,ds)
    bx = (delta[:, 0] * xa[:, 0].float())[..., None] * b_mat[:, 0, None, :]
    h = a_bar * state.ssm + bx
    y = torch.sum(h * c_mat[:, 0, None, :], dim=-1)
    y = y + params["D"].float() * xa[:, 0].float()
    y = (y[:, None, :] * F.silu(z).float()).to(x.dtype)
    state.conv.copy_(window[:, 1:])
    state.ssm.copy_(h)
    out = y @ params["out_proj"]
    return (model_axis.reduce_out(out) if tp else out), state

"""Top-k mixture-of-experts FFN with capacity-bounded gather dispatch, the
JAX package's ``models/layers/moe.py`` in PyTorch.

Dispatch is a gather and a scatter, not a one-hot product: each of the
T·k (token, choice) slots gets a position in its expert from a running
count in token-major order; slots past the expert's capacity drop (they
write to one spare row and read back zero). The experts are SwiGLU
products batched over the expert axis. Every shape is static and nothing
is read back to the host, so a CUDA-graph window can capture the layer.

Routing is the reference's bit for bit in f32: the top k of the softmax
are chosen by a stable descending sort, which breaks ties toward the
lower expert index as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among equal values, and equal router logits are not rare: a zero
hidden state gives them for every expert).

The Switch-style load-balance loss is returned beside the output.

Each weight carries the JAX package's logical axes ('embed', 'expert',
'expert_mlp'); only ``parallel.sharding`` maps them to a mesh. Under a
model axis (``parallel.model_axis``) every rank holds the whole input and
routes every token, replicated: the router, the softmax, top-k and the
aux loss, and the slot positions, so capacity and drops are the whole
routing's. With 'expert' sharded (arctic) a rank holds E/M whole experts
and dispatches only the slots routed to them; with 'expert_mlp' sharded
(grok) it holds every expert's block of hidden units (the up and gate
products column-parallel, ``wo`` row-parallel). Either way its combine
is a partial sum of the output, all-reduced over the group with a dense
residual's partial when the rules shard its 'mlp' too; the input's and
the gates' gradients, each partial on a rank, are all-reduced.

**Sigmoid routing** (``moe.score_func`` 'sigmoid', afmoe/Trinity;
``apply_sigmoid``): scores s = sigmoid(x W_r), the router's product in
f32; the top k chosen on s + bias (afmoe's expert bias is held at 0,
its initial value: its update rule is a training recipe's, left out);
the gates are the chosen scores over their sum (+1e-20), times
``route_scale``; a shared SwiGLU expert (``shared_d_ff``) adds its output
for every token. Dropless, with no aux loss. The layer holds
``experts_held`` experts (the chip's share under expert parallelism, the
router keeping every expert's output): it computes only the slots routed
to them, through ``kernels.ops.grouped_mm`` over the slots sorted by
expert, and a slot routed elsewhere adds 0 (the absent chips' part of the
result is left out). Shapes are static and nothing is read back to the
host, so a CUDA graph captures the layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.params import ParamSpec, fan_in_init
from repro_torch.runtime import trace


def spec(cfg) -> Dict[str, Any]:
    assert cfg.moe is not None
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff or cfg.d_ff, m.num_experts
    p: Dict[str, Any] = {
        "router": ParamSpec((d, e), ("embed", None), fan_in_init(0)),
        "wi_gate": ParamSpec((m.held, d, f),
                             ("expert", "embed", "expert_mlp"),
                             fan_in_init(1)),
        "wi_up": ParamSpec((m.held, d, f), ("expert", "embed", "expert_mlp"),
                           fan_in_init(1)),
        "wo": ParamSpec((m.held, f, d), ("expert", "expert_mlp", "embed"),
                        fan_in_init(1)),
    }
    if m.shared_d_ff:
        p["shared"] = mlp_mod.spec(cfg, d_ff=m.shared_d_ff)
    if cfg.moe.dense_residual:
        # Arctic: a small dense MLP runs in parallel with the MoE FFN.
        p["residual"] = mlp_mod.spec(cfg, d_ff=cfg.moe.residual_d_ff
                                     or cfg.d_ff)
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots an expert holds for ``tokens`` tokens: the reference's
    arithmetic, rounded up to a multiple of 8 (it decides which slots
    drop)."""
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs, gate values, expert indices) of f32 router logits (T, E):
    the softmax, its k largest entries in descending order with ties to
    the lower index, and those entries renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    gates = torch.gather(probs, -1, idx)
    return probs, gates / torch.sum(gates, dim=-1, keepdim=True), idx


def slots(expert_idx: torch.Tensor, num_experts: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(destination row, kept) of each of the T·k slots, token-major: an
    expert's slots fill its ``cap`` rows in order; a dropped slot's row
    is ``num_experts * cap``, the spare one."""
    flat = expert_idx.reshape(-1)
    onehot = (flat[:, None] == torch.arange(num_experts, device=flat.device)
              ).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, flat[:, None])[:, 0]
    kept = pos < cap
    dst = torch.where(kept, flat * cap + pos,
                      torch.full_like(flat, num_experts * cap))
    return dst, kept


def gate(params: Dict[str, Any], xt: torch.Tensor, cfg
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing: (gate values (T, k) f32, expert indices (T, k), the f32
    aux loss) of the tokens ``xt`` (T, D). The router product runs in the
    compute dtype, the softmax in f32."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    t = xt.shape[0]
    probs, gates, idx = route((xt @ params["router"]).float(), k)
    # Aux loss: mean prob per expert x fraction of slots routed (Switch).
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=xt.device) \
        .index_add_(0, idx.reshape(-1),
                    torch.ones((t * k,), dtype=torch.float32,
                               device=xt.device)) / (t * k)
    return gates, idx, e * torch.sum(me * ce) * m.aux_loss_weight


def dispatch(xt: torch.Tensor, idx: torch.Tensor, num_experts: int,
             cap: int, experts: Optional[slice] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the experts' buffer (E, cap, D), each slot's row, kept): the
    slots' tokens scattered into an (E·cap + 1, D) buffer whose last row
    takes the dropped slots and is cut off. ``experts``: only the buffer
    of that contiguous range of experts (a rank's under expert
    parallelism), whose rows start at 0; a slot routed elsewhere counts
    as not kept here. Positions and drops are the whole routing's."""
    (t, d), k = xt.shape, idx.shape[1]
    dst, kept = slots(idx, num_experts, cap)
    if experts is not None:
        rows = (experts.stop - experts.start) * cap
        dst = dst - experts.start * cap
        kept = kept & (dst >= 0) & (dst < rows)
        dst = torch.where(kept, dst, torch.full_like(dst, rows))
        num_experts = experts.stop - experts.start
    src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((num_experts * cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf = buf.index_put((dst,), src)[:-1]
    return buf.reshape(num_experts, cap, d), dst, kept


def experts(params: Dict[str, Any], buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts, batched over the expert axis: (E, cap, D) ->
    (E·cap, D)."""
    h = F.silu(torch.bmm(buf, params["wi_gate"])) \
        * torch.bmm(buf, params["wi_up"])
    out = torch.bmm(h, params["wo"])
    return out.reshape(-1, out.shape[-1])


def combine(out: torch.Tensor, dst: torch.Tensor, kept: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """Gather each slot's expert output back and weight it by its gate in
    the compute dtype; a dropped slot adds 0. Each token's k
    contributions are added to zero in slot order, the reference's
    scatter-add. Returns (T, D)."""
    t, k = gates.shape
    rows, d = out.shape
    slot_out = torch.where(kept[:, None],
                           out[torch.clamp(dst, max=rows - 1)],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
    weighted = (slot_out * gates.reshape(-1)[:, None].to(out.dtype)) \
        .reshape(t, k, d)
    y = torch.zeros((t, d), dtype=out.dtype, device=out.device)
    for j in range(k):
        y = y + weighted[:, j]
    return y


def route_sigmoid(logits: torch.Tensor, k: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, expert indices (T, k)) of f32 router logits (T,
    E): the sigmoid scores, the k largest of scores + the expert bias (0)
    in descending order with ties to the lower index, their scores over
    their sum (+1e-20), times ``scale``."""
    scores = torch.sigmoid(logits)
    idx = torch.sort(scores.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    g = torch.gather(scores, -1, idx)
    return g / (torch.sum(g, dim=-1, keepdim=True) + 1e-20) * scale, idx


def sort_slots(idx: torch.Tensor, held: int, first: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, counts) of the T·k slots, token-major: ``order`` lists the
    slots routed to experts first .. first + held - 1 grouped by expert,
    each expert's in slot order (a stable sort), then the slots routed
    elsewhere; ``counts`` (held,) int32, each expert's slots. On the
    device, nothing read back."""
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local,
                      torch.full_like(local, held))
    keys, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(keys, torch.arange(1, held + 1,
                                                 device=keys.device))
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return order, (ends - starts).to(torch.int32)


class _CountRows(torch.autograd.Function):
    """The identity on the layer's output, whose backward (once a step,
    under layer remat too) adds the held experts' slots to the ``moe``
    tally ``rows``."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.rows = rows
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        trace.tally("moe", "rows", ctx.rows)
        return dy, None


def apply_sigmoid(params: Dict[str, Any], x: torch.Tensor, cfg,
                  first: int = 0, model_axis=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """afmoe's MoE layer (module docstring) on the experts ``params``
    holds, the global experts ``first`` .. ``first + held - 1``: x (B, S,
    D) -> (output (B, S, D), a zero aux loss). Each token's gated
    contributions are added in slot order, then the shared expert's."""
    if model_axis is not None and model_axis.size > 1:
        raise NotImplementedError(
            "the sigmoid-routed MoE layer runs one chip's share of the "
            "experts: the all-to-all between expert-parallel chips is not "
            "written")
    m = cfg.moe
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xt = x.reshape(t, d)
    held = params["wi_gate"].shape[0]
    with trace.span("moe.route"):
        # In f32, so that the compute dtype's rounding of the logits
        # does not reorder the top k.
        gates, idx = route_sigmoid(xt.float() @ params["router"].float(),
                                   k, m.route_scale)
    with trace.span("moe.permute"):
        order, counts = sort_slots(idx, held, first)
        xs = xt[order // k]
    with trace.span("moe.experts"):
        h = F.silu(ops.grouped_mm(xs, params["wi_gate"], counts)) \
            * ops.grouped_mm(xs, params["wi_up"], counts)
        out = ops.grouped_mm(h, params["wo"], counts)
    with trace.span("moe.combine"):
        pos = torch.empty_like(order)
        pos[order] = torch.arange(t * k, device=order.device)
        # A slot no held expert takes reads a zero row.
        weighted = out[pos].view(t, k, d) * gates.to(out.dtype)[..., None]
        y = weighted[:, 0]
        for j in range(1, k):
            y = y + weighted[:, j]
    if m.shared_d_ff:
        y = y + mlp_mod.partial(params["shared"], xt, cfg)
    y = _CountRows.apply(y, counts.sum())
    return y.reshape(b, s, d), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def apply(params: Dict[str, Any], x: torch.Tensor, cfg, model_axis=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (output (B, S, D), f32 aux loss). Under a model
    axis (see the module docstring) every rank holds the whole x and
    returns the whole output."""
    m = cfg.moe
    if m.score_func == "sigmoid":
        return apply_sigmoid(params, x, cfg, model_axis=model_axis)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, aux = gate(params, xt, cfg)
    cap = capacity(cfg, b * s)
    axis = model_axis

    def sharded(name):
        return axis is not None and axis.sharded(name)

    ep, split_res = sharded("expert"), m.dense_residual and sharded("mlp")
    split = ep or sharded("expert_mlp")
    xin = axis.copy_in(xt) if split or split_res else xt
    if split:
        # Each rank's combine sees only its experts' (or hidden units')
        # share: the gates' gradient is summed over the group.
        gates = axis.copy_in(gates)
    mine = axis.block(m.num_experts) if ep else None
    buf, dst, kept = dispatch(xin if split else xt, idx, m.num_experts,
                              cap, mine)
    y = combine(experts(params, buf), dst, kept, gates)
    res = None
    if m.dense_residual:
        res = mlp_mod.partial(params["residual"], xin, cfg) if split_res \
            else mlp_mod.apply(params["residual"], xt, cfg)
    if split and split_res:  # one all-reduce joins both partial sums
        y = axis.reduce_out(y + res)
    else:
        if split:
            y = axis.reduce_out(y)
        if split_res:
            res = axis.reduce_out(res)
        if res is not None:
            y = y + res
    return y.reshape(b, s, d), aux

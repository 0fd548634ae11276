"""Feed-forward blocks: SwiGLU, GeGLU and plain GELU. Weights are stored
(in, out) and used as ``x @ W``, the JAX package's layout. GELU is the
tanh approximation, ``jax.nn.gelu``'s default.

The weights carry the JAX package's logical axes ('embed', 'mlp');
``parallel.sharding`` alone maps them to a mesh. When the rules shard
'mlp' over a model axis (``parallel.model_axis``) the block is Megatron's:
the input projections column-parallel, ``wo`` row-parallel, its partial
sum all-reduced over the model group."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, fan_in_init


def spec(cfg, d_ff: int = 0) -> Dict[str, ParamSpec]:
    """``d_ff`` (0: ``cfg.d_ff``) sets the hidden width: arctic's residual
    MLP has its own."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"wi_gate": ParamSpec((d, f), ("embed", "mlp"),
                                     fan_in_init(0)),
                "wi_up": ParamSpec((d, f), ("embed", "mlp"), fan_in_init(0)),
                "wo": ParamSpec((f, d), ("mlp", "embed"), fan_in_init(0))}
    return {"wi": ParamSpec((d, f), ("embed", "mlp"), fan_in_init(0)),
            "wo": ParamSpec((f, d), ("mlp", "embed"), fan_in_init(0))}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          cfg, model_axis=None) -> torch.Tensor:
    if model_axis is not None and model_axis.sharded("mlp"):
        x = model_axis.copy_in(x)
        return model_axis.reduce_out(partial(params, x, cfg))
    return partial(params, x, cfg)


def partial(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg) -> torch.Tensor:
    """The block on the weights given: the whole output on whole
    weights, a rank's partial sum of it on its column and row blocks."""
    if cfg.activation in ("swiglu", "geglu"):
        gate = x @ params["wi_gate"]
        up = x @ params["wi_up"]
        act = F.silu(gate) if cfg.activation == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]

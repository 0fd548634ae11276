"""Model FLOPs of one training step: a frozen copy of the ``model`` count
of ``step_flops`` in ``chip_smoke.py`` (the transformer families), so
that a change to the program cannot change the yardstick.

6 per matmul weight per token (forward 2, backward 4), and attention's
two products (QK^T and PV) over the causal half of the S x S grid,
forward and backward (6 S h hd a token a layer). No recompute is
counted: remat's second forward is the program's cost, not the model's.
A MoE layer's weights count as the router and ``top_k`` of its
``num_experts`` experts a token (the active weights). A vlm's vision
positions run through the layers and attention but not the head; an
audio model has one head a codebook. The embedding counts once, as the
head's matmul (tied or not: the input lookup is no product).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence


def numel(shapes: Dict[str, Sequence[int]], prefix: str = "",
          ndim=None) -> int:
    """Elements of the leaves whose name starts with ``prefix`` (and of
    ``ndim`` dimensions, when given)."""
    return sum(math.prod(s) for name, s in shapes.items()
               if name.startswith(prefix)
               and (ndim is None or len(s) == ndim))


def step_flops(model: Dict, shapes: Dict[str, Sequence[int]], batch: int,
               seq_len: int) -> float:
    """The model FLOPs of one step over ``batch`` rows of ``seq_len``.
    ``model``: the configuration's sizes (``num_hidden_layers``,
    ``hidden_size``, ``num_attention_heads``, ``head_dim``,
    ``vocab_size``, and as they apply ``num_codebooks``,
    ``num_vision_tokens``, ``num_experts``, ``num_experts_per_tok``);
    ``shapes``: every weight's shape by its name, the layer stacks under
    ``layers/``."""
    vision = model.get("num_vision_tokens", 0)
    seq = seq_len + vision
    rows = batch * seq                  # positions through the layers
    text = batch * seq_len              # positions through the head
    codebooks = max(model.get("num_codebooks", 1), 1)
    head = codebooks * model["vocab_size"] * model["hidden_size"]
    heads = model["num_attention_heads"]
    head_dim = model.get("head_dim") or model["hidden_size"] // heads
    # The stacked experts are the 4-D (L, E, ., .) leaves of the FFN.
    experts = numel(shapes, "layers/ffn/", 4)
    dense = numel(shapes, "layers/") - experts
    active = 0
    if experts:
        active = rows * model["num_experts_per_tok"] * experts \
            / model["num_experts"]
    attn = seq * heads * head_dim * model["num_hidden_layers"]
    return float(6 * (rows * dense + active) + 6 * text * head
                 + 6 * rows * attn)

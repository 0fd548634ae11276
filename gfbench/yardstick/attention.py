"""FLOPs of attention's products in the flash-attention kernels, from the
shapes alone: the (query, key) pairs each layer's mask keeps (the causal
half, or under a sliding window of W the W latest keys a query), times
the head dim and the heads, at the flash kernels' count of products: 2
in the forward (QK^T, PV), 5 in the backward (QK^T and dP rebuilt, dV,
dK, dQ), 2 FLOPs a multiply-add. Layer remat runs the forward twice."""
from __future__ import annotations

from typing import Dict, List

FORWARD_PRODUCTS = 2
BACKWARD_PRODUCTS = 5


def kept_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs of one row with 0 <= i - j, and i - j < window
    when a window is given."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def layer_windows(model: Dict) -> List[int]:
    """Each layer's window (0: full causal), from ``layer_types`` and
    ``sliding_window`` (every layer full without them)."""
    kinds = model.get("layer_types") or []
    return [model["sliding_window"] if i < len(kinds)
            and kinds[i] == "sliding_attention" else 0
            for i in range(model["num_hidden_layers"])]


def step_flops(model: Dict, batch: int, seq_len: int, remat: bool) -> float:
    """Attention products' FLOPs of one training step over ``batch`` rows
    of ``seq_len``."""
    heads = model["num_attention_heads"]
    head_dim = model.get("head_dim") or model["hidden_size"] // heads
    products = FORWARD_PRODUCTS * (2 if remat else 1) + BACKWARD_PRODUCTS
    pairs = sum(kept_pairs(seq_len, w) for w in layer_windows(model))
    return float(2 * products * pairs * head_dim * heads * batch)

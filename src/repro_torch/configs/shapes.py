"""The input-shape cells of the LM transformers, and AlexNet's gradient
tensors (the paper's headline pool, no model needed)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ShapeConfig

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig(name="train_4k", seq_len=4096,
                            global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig(name="prefill_32k", seq_len=32768,
                               global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig(name="decode_32k", seq_len=32768,
                              global_batch=128, kind="decode"),
    "long_500k": ShapeConfig(name="long_500k", seq_len=524288,
                             global_batch=1, kind="decode"),
}


# AlexNet's gradient tensors (merged single-tower variant): 5 conv + 3 fc
# layers, weights and biases, 16 tensors, ~62.4 M parameters: two huge fc
# tensors and a tail of tiny biases, the paper's Table 1 footprint.
ALEXNET_GRAD_SHAPES = [
    (96, 3, 11, 11), (96,),
    (256, 96, 5, 5), (256,),
    (384, 256, 3, 3), (384,),
    (384, 384, 3, 3), (384,),
    (256, 384, 3, 3), (256,),
    (9216, 4096), (4096,),
    (4096, 4096), (4096,),
    (4096, 1000), (1000,),
]


def shapes_for(cfg) -> List[ShapeConfig]:
    """The shape cells an architecture runs. long_500k needs sub-quadratic
    attention: pure full-attention architectures skip it."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out

"""internvl2-26b [vlm] — InternViT frontend (stubbed: precomputed patch
embeddings) + InternLM2-20B backbone: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553 [arXiv:2404.16821; hf].

vocab padded 92553 -> 92672 (a multiple of 128), as in the JAX package;
the pad rows are never addressed."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92672,  # 92553 padded to a 128 multiple
    norm="rmsnorm", activation="swiglu",
    num_vision_tokens=256,
    max_seq_len=32768,
)

RULES = make_rules(kv_heads=None)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=256, num_vision_tokens=16,
    norm="rmsnorm", activation="swiglu",
)

"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    max_seq_len=32768,
)

RULES = make_rules(kv_heads=None, expert=None, expert_mlp="model")

SMOKE = ModelConfig(
    name="grok1-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=256,
    norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=4, top_k=2),
)

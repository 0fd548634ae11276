"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) head_dim=128
d_ff=25600 vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    norm="rmsnorm", activation="swiglu", qk_norm=True,
    max_seq_len=32768,
)

RULES = make_rules(kv_heads=None)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=256, vocab_size=256,
    norm="rmsnorm", activation="swiglu", qk_norm=True,
)

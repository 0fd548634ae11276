"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352, LayerNorm [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    norm="layernorm", activation="swiglu",
    max_seq_len=32768,
)

RULES = make_rules(kv_heads=None)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=256,
    norm="layernorm", activation="swiglu",
)

"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192
vocab=50304, non-parametric LN, tied embeddings [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="nonparametric_ln", activation="swiglu", tie_embeddings=True,
    max_seq_len=32768,
)

RULES = make_rules()

SMOKE = ModelConfig(
    name="olmo-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256,
    norm="nonparametric_ln", activation="swiglu", tie_embeddings=True,
)

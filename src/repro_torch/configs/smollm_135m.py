"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama arch [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152,
    norm="rmsnorm", activation="swiglu", tie_embeddings=True,
    max_seq_len=32768,
)

RULES = make_rules(heads=None, kv_heads=None, qkv=None)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=3, num_kv_heads=1,
    d_ff=256, vocab_size=256,
    norm="rmsnorm", activation="swiglu", tie_embeddings=True,
)

"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True,
                  residual_d_ff=4864, capacity_factor=1.25),
    max_seq_len=32768,
)

RULES = make_rules(heads=None, kv_heads=None, qkv=None,
                   expert="model", expert_mlp=None)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=256,
    norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, dense_residual=True,
                  residual_d_ff=64),
)

"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba-2 backbone (ssm_state=64,
head_dim=64) + one shared attention block (32H MHA + MLP d_ff=10240)
applied every 6 layers [arXiv:2411.15242; hf].
Runs long_500k (hybrid recurrent decode)."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    norm="rmsnorm", activation="swiglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, head_dim=64),
    hybrid_attn_every=6,
    max_seq_len=524288,
)

RULES = make_rules()

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256,
    norm="rmsnorm", activation="swiglu",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=2, head_dim=32),
    hybrid_attn_every=2,
)

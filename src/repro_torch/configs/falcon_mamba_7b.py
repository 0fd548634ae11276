"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free Mamba-1,
ssm_state=16, vocab=65024 [arXiv:2410.05355; unverified].
Runs long_500k (recurrent O(1)-state decode)."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    max_seq_len=524288,
)

RULES = make_rules()

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    num_layers=3, d_model=128, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=256,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, version=1),
)

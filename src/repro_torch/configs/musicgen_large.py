"""musicgen-large [audio] — decoder-only over EnCodec tokens.
48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048, 4 codebooks
[arXiv:2306.05284; hf]. Frontend (EnCodec) is stubbed: the backbone
consumes codec token ids; 4 codebook embeddings summed, 4 output heads."""
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import make_rules

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, num_codebooks=4,
    norm="layernorm", activation="gelu", qk_norm=False,
    max_seq_len=32768,
)

RULES = make_rules()

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=128, num_codebooks=4,
    norm="layernorm", activation="gelu",
)

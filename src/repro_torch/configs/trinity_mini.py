"""trinity-mini [moe, afmoe] — 32L d_model=2048 32H (GQA kv=4, head 128)
vocab=200192 untied; 2 leading dense SwiGLU layers of 6144, then 30 MoE
layers of 128 sigmoid-routed SwiGLU experts of 1024, top-8, and 1 shared
expert of 1024; sliding attention (window 2048) on 3 layers of every 4,
NoPE on the full ones; gated attention, sandwich norms, the embedding
scaled by sqrt(2048) (mup) [hf:arcee-ai/Trinity-Mini, model type afmoe].
The port's own architecture: the JAX package has none like it.

``EP4``, arch id ``trinity-mini-ep4``: one chip's share of an
expert-parallel deployment over 4 chips. The chip holds experts 0-31 of
each MoE layer (the router keeps its 128 outputs) and vocabulary rows
0-50,047 (the embedding and head split over the same 4); layers 0-5 (2
dense, then MoE layers of kind sliding, full, sliding, sliding: one
period of the 3:1 pattern), the other 26 on further pipeline stages.
Every width is the published one."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.parallel.sharding import make_rules

LAYER_TYPES = ("sliding", "sliding", "sliding", "full") * 8

CONFIG = ModelConfig(
    name="trinity-mini", family="moe",
    num_layers=32, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=6144, vocab_size=200192, max_seq_len=131072,
    norm="rmsnorm", qk_norm=True, activation="swiglu", rope_theta=10000.0,
    moe=MoEConfig(num_experts=128, top_k=8, aux_loss_weight=0.0,
                  score_func="sigmoid", route_scale=2.826, expert_d_ff=1024,
                  shared_d_ff=1024),
    norm_eps=1e-5, layer_types=LAYER_TYPES, sliding_window=2048,
    rope_full=False, attn_gate=True, sandwich_norm=True,
    embed_scale=2048 ** 0.5, num_dense_layers=2,
)

EP4 = dataclasses.replace(
    CONFIG, name="trinity-mini-ep4", num_layers=6, vocab_size=50048,
    layer_types=LAYER_TYPES[:6],
    moe=dataclasses.replace(CONFIG.moe, experts_held=32))

# No model axis: the all-to-all between expert-parallel chips is not
# written (the MoE layer refuses one).
RULES = make_rules()

SMOKE = dataclasses.replace(
    CONFIG, name="trinity-smoke", num_layers=6, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256, max_seq_len=64,
    layer_types=LAYER_TYPES[:6], sliding_window=16, embed_scale=64 ** 0.5,
    moe=dataclasses.replace(CONFIG.moe, num_experts=8, top_k=2,
                            expert_d_ff=32, shared_d_ff=32, experts_held=4))

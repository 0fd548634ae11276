"""Configuration dataclasses of the PyTorch port.

Field for field the same as the JAX package's ``configs/base.py`` (same
names, same defaults), so a config written for one package reads the same
in the other, and after them the fields of the architectures only the
port runs (``PORT_FIELDS``), whose defaults leave every JAX architecture
as it was. ``GradientFlowConfig.topology`` holds the port's own
``Topology`` (``repro_torch.parallel.topology``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.parallel.topology import Topology


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for an FFN block."""

    num_experts: int = 8
    top_k: int = 2
    # Arctic-style dense residual MLP running in parallel with the MoE FFN.
    dense_residual: bool = False
    residual_d_ff: int = 0
    # Load-balancing auxiliary loss weight (Switch-style).
    aux_loss_weight: float = 0.01
    # Capacity factor for expert token buffers (static shapes).
    capacity_factor: float = 1.25
    # The port's own (``PORT_FIELDS``). 'sigmoid': afmoe's routing,
    # dropless (``models.layers.moe.apply_sigmoid``); 'softmax' the JAX
    # package's capacity-bounded top-k.
    score_func: str = "softmax"
    route_scale: float = 1.0    # the sigmoid gates' sum after renorming
    expert_d_ff: int = 0        # 0 => the model's d_ff
    shared_d_ff: int = 0        # a shared SwiGLU expert's width; 0: none
    experts_held: int = 0       # experts 0..held-1 on this chip; 0: all

    PORT_FIELDS = ("score_func", "route_scale", "expert_d_ff",
                   "shared_d_ff", "experts_held")

    @property
    def held(self) -> int:
        return self.experts_held or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba) block settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # mamba2 uses multi-head SSD with scalar A per head.
    version: int = 1
    n_heads: int = 0  # mamba2 only; 0 => derived as d_inner // head_dim
    head_dim: int = 64  # mamba2 only


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config. ``family`` selects the model
    (``models.build_model``): on ``TransformerLM`` 'dense', 'moe' (MoE FFN
    blocks, ``moe``), 'vlm' (``num_vision_tokens`` precomputed patch
    embeddings prepended) and 'audio' (``num_codebooks`` codec token
    streams); 'ssm', the attention-free Mamba-1 LM (``MambaLM``), and
    'hybrid', a Mamba-2 backbone with one shared attention block applied
    every ``hybrid_attn_every`` blocks (``HybridLM``), both set by
    ``ssm``. ``norm`` 'rmsnorm', 'layernorm' or 'nonparametric_ln',
    ``activation`` 'swiglu', 'geglu' or 'gelu', with or without
    ``qk_norm``."""

    name: str = "model"
    family: str = "dense"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192
    norm: str = "rmsnorm"
    qk_norm: bool = False
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 6
    num_vision_tokens: int = 0
    num_codebooks: int = 0
    param_dtype: str = "float32"     # master storage dtype
    compute_dtype: str = "bfloat16"  # fwd/bwd compute dtype
    # The port's own (``PORT_FIELDS``), for afmoe (Trinity): RMSNorm's
    # eps; each layer's attention, 'full' or 'sliding' (empty: every
    # layer full) and the sliding window; RoPE on the full layers (False:
    # NoPE there); attention's sigmoid output gate; a norm after
    # attention and after the FFN as well as before; the embedding's
    # scale; leading layers whose FFN is dense (``d_ff``) in a moe model.
    norm_eps: float = 1e-6
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0
    rope_full: bool = True
    attn_gate: bool = False
    sandwich_norm: bool = False
    embed_scale: float = 1.0
    num_dense_layers: int = 0

    PORT_FIELDS = ("norm_eps", "layer_types", "sliding_window", "rope_full",
                   "attn_gate", "sandwich_norm", "embed_scale",
                   "num_dense_layers")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def window(self, layer: int) -> int:
        """Layer ``layer``'s attention window (0: full causal)."""
        if self.layer_types and self.layer_types[layer] == "sliding":
            return self.sliding_window
        return 0

    def rope(self, layer: int) -> bool:
        """Whether layer ``layer`` rotates q and k."""
        return self.rope_full or self.window(layer) > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (recurrent-state) decode => long_500k is runnable."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The numeric guard rail: in-band gradient health detection and
    dynamic loss scaling with an all-or-nothing step commit (see
    ``core.guard`` and ``optim.scaler``). A NaN/Inf census entry, or a
    finite one at ``overflow_fraction`` of the wire dtype's max, rejects
    the whole step and backs the loss scale off; ``growth_interval``
    clean steps grow it back."""

    # 1.0 keeps a guarded run bit-identical to the unguarded one until
    # something trips; mixed-precision runs start high.
    init_scale: float = 2.0 ** 15
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    # 2^-9 of finfo(wire).max: far above any honest census sum, low
    # enough to catch an exponent-MSB flip of a word in [2^-8, 2).
    overflow_fraction: float = 1.0 / 512.0


@dataclasses.dataclass(frozen=True)
class GradientFlowConfig:
    """The communication backend's settings (see the JAX package for the
    meaning of each field). The port runs ``mode`` 'dense', 'lazy' and
    'csc', every ``wire_format`` ('native', 'int8', 'fp8_e4m3', with or
    without ``error_feedback``), ``overlap`` 'staged' and 'monolithic',
    every ``collective_algo``, ``auto_bucket``, the ``guard`` and
    ``pipeline_tail_buckets`` (the cross-step pipeline, inside a train
    window of more than one step)."""

    mode: str = "lazy"
    bucket_elems: int = 16 * 1024 * 1024
    wire_dtype: str = "bfloat16"
    chunk_elems: int = 32768
    sparsity: float = 0.85
    momentum: float = 0.9
    warmup_steps: int = 0
    warmup_stages: int = 4
    reduce_axes: Tuple[str, ...] = ("data",)
    collective_algo: str = "auto"
    topology: Optional[Topology] = None
    auto_bucket: bool = False
    overlap: str = "staged"
    wire_format: str = "native"
    error_feedback: bool = True
    pipeline_tail_buckets: int = 0
    use_kernels: bool = False
    guard: Optional[GuardConfig] = None

    @property
    def csc_enabled(self) -> bool:
        return self.mode == "csc"

    @property
    def guarded(self) -> bool:
        return self.guard is not None

    @property
    def quantized(self) -> bool:
        return self.wire_format not in (None, "native")

    @property
    def feedback_enabled(self) -> bool:
        return self.quantized and self.error_feedback


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "momentum_sgd"  # 'momentum_sgd' | 'lars' | 'adamw'
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lars_eta: float = 0.001
    lars_eps: float = 1e-9
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 200
    total_steps: int = 10000
    schedule: str = "warmup_cosine"
    grad_clip_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input-shape cell."""

    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    gradientflow: GradientFlowConfig = dataclasses.field(
        default_factory=GradientFlowConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seq_len: int = 4096
    global_batch: int = 256
    microbatches: int = 1
    remat: str = "layer"  # 'none' | 'layer'
    scan_layers: bool = True
    attn_chunk: int = 1024
    causal_skip: bool = False
    window_steps: int = 1
    seed: int = 0

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

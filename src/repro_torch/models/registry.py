"""Model registry: family -> model class (``TransformerLM`` for dense,
moe, vlm and audio; ``MambaLM`` for ssm; ``HybridLM`` for hybrid), and
the inputs of every (architecture x shape) cell.

``input_specs`` returns (shape, dtype) pairs, nothing allocated;
``make_batch`` draws a matching synthetic batch from a
``torch.Generator``. As in the JAX package the modality frontends are
stubs: vlm cells get precomputed patch embeddings, audio cells codec
token ids.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.hybrid_lm import HybridLM
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import (FAMILIES, LanguageModel,
                                            TransformerLM)

Spec = Tuple[Tuple[int, ...], torch.dtype]


def build_model(cfg: ModelConfig) -> LanguageModel:
    if cfg.family in FAMILIES:
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    raise NotImplementedError(
        f"unknown model family {cfg.family!r}; see ROADMAP.md queue A")


def _token_shape(cfg: ModelConfig, batch: int, seq: int) -> Tuple[int, ...]:
    if cfg.family == "audio" and cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                per_shard_batch: int) -> Dict[str, Spec]:
    """One data shard's inputs as (shape, dtype).

    train  : {'tokens', 'labels'} (+ 'vision_embeds' for vlm)
    prefill: {'tokens'} (+ 'vision_embeds' for vlm)
    decode : {'tokens' (B, 1)}: one new token against a seq_len KV cache
    """
    b, s = per_shard_batch, shape.seq_len
    tokens = (_token_shape(cfg, b, s), torch.int32)
    vision = {"vision_embeds": ((b, cfg.num_vision_tokens, cfg.d_model),
                                torch.bfloat16)} \
        if cfg.family == "vlm" else {}
    if shape.kind == "train":
        return {"tokens": tokens, "labels": tokens, **vision}
    if shape.kind == "prefill":
        return {"tokens": tokens, **vision}
    if shape.kind == "decode":
        return {"tokens": (_token_shape(cfg, b, 1), torch.int32)}
    raise ValueError(f"unknown shape kind {shape.kind}")


def make_batch(cfg: ModelConfig, shape: ShapeConfig, per_shard_batch: int,
               gen: torch.Generator,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, torch.Tensor]:
    """A synthetic batch matching ``input_specs``, drawn in its key order
    from ``gen`` (on the generator's device): integers uniform in
    [0, vocab), floats standard normal cast to their dtype. The bits are
    not ``jax.random``'s."""
    dev = gen.device if device is None else torch.device(device)
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape,
                                          per_shard_batch).items():
        if dtype.is_floating_point:
            x = torch.randn(shp, generator=gen, device=gen.device)
        else:
            x = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                              device=gen.device)
        out[name] = x.to(device=dev, dtype=dtype)
    return out

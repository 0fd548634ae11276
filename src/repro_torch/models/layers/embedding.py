"""Token embeddings and the LM head. The audio family (musicgen) has one
embedding table a codebook, whose lookups are summed, and one head a
codebook; its spec keeps the unused ``tokens`` table, as the JAX
package's does, so the leaf table and the pool are the same."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.params import ParamSpec, normal_init


def _codebooks(cfg) -> int:
    """K for a multi-codebook audio model, else 0."""
    return cfg.num_codebooks \
        if cfg.family == "audio" and cfg.num_codebooks > 1 else 0


def spec(cfg) -> Dict[str, ParamSpec]:
    v, d = cfg.vocab_size, cfg.d_model
    p = {"tokens": ParamSpec((v, d), normal_init(0.02))}
    if _codebooks(cfg):
        p["codebooks"] = ParamSpec((cfg.num_codebooks, v, d),
                                   normal_init(0.02))
    return p


def head_spec(cfg) -> Dict[str, ParamSpec]:
    v, d = cfg.vocab_size, cfg.d_model
    if _codebooks(cfg):
        return {"w": ParamSpec((cfg.num_codebooks, d, v), normal_init(0.02))}
    return {"w": ParamSpec((d, v), normal_init(0.02))}


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens: (B, S) integer, or (B, S, K) for multi-codebook audio ->
    (B, S, D) in ``compute_dtype``. The K lookups are summed in codebook
    order from 0, as the JAX package's ``sum`` does."""
    k = _codebooks(cfg)
    if k:
        x = sum(params["codebooks"][i][tokens[..., i]] for i in range(k))
    else:
        x = params["tokens"][tokens]
    return x.to(compute_dtype)


def logits(head_params: Dict[str, torch.Tensor], x: torch.Tensor,
           cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, V), or (B, S, K, V) for audio."""
    if _codebooks(cfg):
        return torch.einsum("bsd,kdv->bskv", x, head_params["w"])
    return x @ head_params["w"]

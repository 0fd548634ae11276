"""Token embeddings and the LM head. The audio family (musicgen) has one
embedding table a codebook, whose lookups are summed, and one head a
codebook; its spec keeps the unused ``tokens`` table, as the JAX
package's does, so the leaf table and the pool are the same.

Each weight carries the JAX package's logical axes ('vocab', 'embed');
``parallel.sharding`` alone maps them to a mesh. Under a model axis
(``parallel.model_axis``) whose rules shard 'vocab' the table holds one
contiguous block of the vocabulary: a lookup is masked to the block and
summed over the model group, and the head's logits are that block's
(``transformer.xent`` then takes the vocab-parallel cross-entropy, over
each of the audio family's K heads alike)."""
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
    p = {"tokens": ParamSpec((v, d), ("vocab", "embed"), normal_init(0.02))}
    if _codebooks(cfg):
        p["codebooks"] = ParamSpec((cfg.num_codebooks, v, d),
                                   (None, "vocab", "embed"),
                                   normal_init(0.02))
    return p


def head_spec(cfg) -> Dict[str, ParamSpec]:
    v, d = cfg.vocab_size, cfg.d_model
    if _codebooks(cfg):
        return {"w": ParamSpec((cfg.num_codebooks, d, v),
                               (None, "embed", "vocab"), normal_init(0.02))}
    return {"w": ParamSpec((d, v), ("embed", "vocab"), normal_init(0.02))}


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
          compute_dtype: torch.dtype, model_axis=None) -> torch.Tensor:
    """tokens: (B, S) integer, or (B, S, K) for multi-codebook audio ->
    (B, S, D) in ``compute_dtype``. The K lookups are summed in codebook
    order from 0, as the JAX package's ``sum`` does. A vocab-sharded
    table: each rank looks up the tokens of its block (zeros elsewhere),
    the audio family sums its K codebooks' lookups so, and the rows are
    summed over the model group: one nonzero term each for one table, so
    the sum is exact."""
    k = _codebooks(cfg)
    if model_axis is not None and model_axis.sharded("vocab"):
        if k:
            x = sum(_local_lookup(params["codebooks"][i], tokens[..., i],
                                  model_axis) for i in range(k))
        else:
            x = _local_lookup(params["tokens"], tokens, model_axis)
        return model_axis.reduce_out(x.to(compute_dtype))
    if k:
        x = sum(params["codebooks"][i][tokens[..., i]] for i in range(k))
    else:
        x = params["tokens"][tokens]
    return x.to(compute_dtype)


def _local_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  model_axis) -> torch.Tensor:
    """The rows of this rank's vocabulary block ``table`` for the tokens
    in it, zeros for the others."""
    n = table.shape[0]
    local = tokens - model_axis.index * n
    mine = (local >= 0) & (local < n)
    return table[local.clamp(0, n - 1)].masked_fill(~mine[..., None], 0)


def logits(head_params: Dict[str, torch.Tensor], x: torch.Tensor,
           cfg, model_axis=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, V), or (B, S, K, V) for audio. A
    vocab-sharded head gives this rank's block of the vocabulary."""
    if model_axis is not None and model_axis.sharded("vocab"):
        x = model_axis.copy_in(x)
    if _codebooks(cfg):
        return torch.einsum("bsd,kdv->bskv", x, head_params["w"])
    return x @ head_params["w"]

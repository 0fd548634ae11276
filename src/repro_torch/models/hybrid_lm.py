"""Zamba2-style hybrid LM (the hybrid family), the training path: a
Mamba-2 backbone and one *shared* attention block (attention + MLP, one
set of weights) applied after every ``hybrid_attn_every`` Mamba-2 blocks.
Its gradient sums over its ``groups`` applications, and the gradient pool
holds it once.

The ``num_layers`` Mamba-2 blocks are stacked (groups, every, ...), the
JAX package's two-level layout. With ``remat='layer'`` each Mamba-2
block is checkpointed, and so is each group around them (the shared
block included), as JAX nests its ``jax.checkpoint``s: a block's forward
runs three times a step (the forward, the group's recompute, its own).

Serving: a ``HybridCache`` holds the Mamba-2 states stacked (groups,
every, ...) and one KV cache a group, stacked (groups, ...): the shared
block's weights are one, its caches one an application. The prefill
runs the Mamba-2 training path and writes the KV caches, and leaves the
Mamba-2 states as they were passed in, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import params as params_mod
from repro_torch.models.layers import attention, embedding, mamba2, mlp, norms
from repro_torch.models.params import index_struct, stack_abstract
from repro_torch.models.transformer import (LanguageModel, checkpointed,
                                            unstack, xent)


class HybridCache(NamedTuple):
    mamba: Any  # mamba2.Mamba2State stacked (groups, every, ...)
    attn: Any   # attention.KVCache stacked (groups, ...)


def mamba_block_spec(cfg) -> Dict[str, Any]:
    return {"norm": norms.spec(cfg), "mixer": mamba2.spec(cfg)}


def shared_block_spec(cfg) -> Dict[str, Any]:
    return {
        "attn_norm": norms.spec(cfg),
        "attn": attention.spec(cfg),
        "mlp_norm": norms.spec(cfg),
        "mlp": mlp.spec(cfg),
    }


class HybridLM(LanguageModel):
    def __init__(self, cfg):
        if cfg.family != "hybrid" or cfg.ssm is None:
            raise ValueError(f"HybridLM needs family 'hybrid' and an "
                             f"SSMConfig, got {cfg.family!r}, {cfg.ssm}")
        every = cfg.hybrid_attn_every
        if cfg.num_layers % every:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of hybrid_attn_every {every}")
        self.cfg = cfg
        self.groups = cfg.num_layers // every
        self.every = every

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        inner = params_mod.stack_spec(mamba_block_spec(cfg), self.every)
        p: Dict[str, Any] = {
            "embed": embedding.spec(cfg),
            "mamba_layers": params_mod.stack_spec(inner, self.groups),
            "shared_attn": shared_block_spec(cfg),
            "final_norm": norms.spec(cfg),
        }
        if not cfg.tie_embeddings:
            p["head"] = embedding.head_spec(cfg)
        return p

    def _shared_attn_apply(self, shared: Dict[str, Any], x: torch.Tensor,
                           attn_chunk: int, causal_skip: bool,
                           model_axis=None) -> torch.Tensor:
        cfg = self.cfg
        h = norms.apply(shared["attn_norm"], x, cfg.norm)
        x = x + attention.apply_train(shared["attn"], h, cfg,
                                      attn_chunk=attn_chunk,
                                      causal_skip=causal_skip,
                                      model_axis=model_axis)
        h = norms.apply(shared["mlp_norm"], x, cfg.norm)
        return x + mlp.apply(shared["mlp"], h, cfg, model_axis=model_axis)

    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                *, remat: str = "layer", attn_chunk: int = 0,
                causal_skip: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                model_axis=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens', 'labels'} (B, S) int; ``attn_chunk`` and
        ``causal_skip`` reach the shared block's attention. Under
        ``model_axis`` (``parallel.model_axis``) ``params`` are this
        rank's shards (the shared block's too: its gradient sums over its
        applications on each rank, its replicated norm scales see the
        whole activations) and every rank returns the same loss. Returns
        (loss, {'loss', 'aux_loss': 0})."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)
        shared = params["shared_attn"]
        remat_on = remat == "layer"

        def mamba_block(lp, h):
            return h + mamba2.apply_train(
                lp["mixer"], norms.apply(lp["norm"], h, cfg.norm), cfg,
                model_axis=model_axis)

        def group(blocks, h):
            for lp in blocks:
                h = checkpointed(lambda hh, lp=lp: mamba_block(lp, hh), h) \
                    if remat_on else mamba_block(lp, h)
            return self._shared_attn_apply(shared, h, attn_chunk,
                                           causal_skip, model_axis)

        for gp in unstack(params["mamba_layers"], self.groups):
            blocks = unstack(gp, self.every)
            x = checkpointed(lambda h, b=blocks: group(b, h), x) \
                if remat_on else group(blocks, x)
        x = norms.apply(params["final_norm"], x, cfg.norm)
        lg = embedding.logits(self._head_params(params), x, cfg,
                              model_axis=model_axis)
        loss = xent(lg, batch["labels"], batch.get("loss_mask"),
                    model_axis=model_axis)
        return loss, {"loss": loss, "aux_loss": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

    # -- serving ------------------------------------------------------------

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16) -> HybridCache:
        """The Mamba-2 states (groups, every, ...) and the KV caches
        (groups, ...) of ``max_len`` positions, as (shape, dtype)."""
        cfg = self.cfg
        return HybridCache(
            mamba=stack_abstract(mamba2.abstract_state(cfg, batch, dtype),
                                 (self.groups, self.every)),
            attn=stack_abstract(attention.abstract_cache(cfg, batch,
                                                         max_len, dtype),
                                (self.groups,)))

    def cache_logical_axes(self) -> HybridCache:
        ma = mamba2.state_logical_axes()
        aa = attention.cache_logical_axes()
        return HybridCache(
            mamba=mamba2.Mamba2State(conv=("layers", None) + ma.conv,
                                     ssm=("layers", None) + ma.ssm),
            attn=attention.KVCache(k=("layers",) + aa.k,
                                   v=("layers",) + aa.v, index=("layers",)))

    def serve_local(self, params: Dict[str, Any], model_axis
                    ) -> Dict[str, Any]:
        """The Mamba-2 blocks' serving view (``mamba2.serve_local``, the
        stacked mixers at once); the other leaves as they are."""
        p = dict(params)
        p["mamba_layers"] = dict(
            params["mamba_layers"], mixer=mamba2.serve_local(
                params["mamba_layers"]["mixer"], self.cfg, model_axis))
        return p

    @torch.no_grad()
    def serve_step(self, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], cache: HybridCache, *,
                   mode: str = "decode",
                   compute_dtype: torch.dtype = torch.bfloat16,
                   split_combine: bool = False, model_axis=None
                   ) -> Tuple[torch.Tensor, HybridCache]:
        """Each group's Mamba-2 blocks, then the shared block with the
        group's KV cache. 'prefill': batch['tokens'] (B, S) through the
        training path, the caches written, the Mamba-2 states untouched;
        'decode': one token (B, 1) a row, every state and cache advanced
        in place. Under ``model_axis`` ``params`` are ``serve_local``'s
        and the cache the rank's blocks. Returns (logits, the cache
        passed in)."""
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown serve mode {mode!r}")
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)
        shared = params["shared_attn"]
        for g, gp in enumerate(unstack(params["mamba_layers"],
                                       self.groups)):
            states = index_struct(cache.mamba, g)
            for i, lp in enumerate(unstack(gp, self.every)):
                y = norms.apply(lp["norm"], x, cfg.norm)
                if mode == "prefill":
                    y = mamba2.apply_train(lp["mixer"], y, cfg,
                                           model_axis=model_axis,
                                           prepared=True)
                else:
                    y, _ = mamba2.apply_decode(lp["mixer"], y, cfg,
                                               index_struct(states, i),
                                               model_axis=model_axis)
                x = x + y
            h = norms.apply(shared["attn_norm"], x, cfg.norm)
            kv = index_struct(cache.attn, g)
            if mode == "prefill":
                h, _ = attention.apply_prefill(shared["attn"], h, cfg, kv,
                                               attn_chunk=2048,
                                               model_axis=model_axis)
            else:
                h, _ = attention.apply_decode(shared["attn"], h, cfg, kv,
                                              split_combine=split_combine,
                                              model_axis=model_axis)
            x = x + h
            h = norms.apply(shared["mlp_norm"], x, cfg.norm)
            x = x + mlp.apply(shared["mlp"], h, cfg, model_axis=model_axis)
        x = norms.apply(params["final_norm"], x, cfg.norm)
        return self._serve_logits(params, x, model_axis), cache

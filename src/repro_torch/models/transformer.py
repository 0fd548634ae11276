"""Decoder-only transformer LM: the dense, moe, vlm and audio families,
and what every family's LM shares (``LanguageModel``, ``xent``).
RMSNorm, LayerNorm or the non-parametric LayerNorm (``cfg.norm``),
SwiGLU, GeGLU or GELU, optional QK-norm, full or blockwise attention
(``attn_chunk``, ``causal_skip``); MoE FFN blocks (``cfg.moe``) whose
load-balance losses are summed over the layers; precomputed vision
embeddings prepended (vlm); K codec token streams summed in and K heads
out (audio).

Parameters are a nested dict in the JAX package's layout: layer weights
stacked along a leading L axis (one tensor per leaf, so the gradient
pool has the JAX package's 11-leaf table for smollm-135m), matrices
stored (in, out) and used as ``x @ W``, the tied head ``embed.T``. The
layer loop indexes the stacks (``unbind``) and wraps each layer in
``torch.utils.checkpoint`` when ``remat='layer'``.

Layers that differ (the port's afmoe, Trinity): each layer's attention
kind comes from ``cfg.layer_types`` (sliding-window or full, NoPE on the
full ones without ``rope_full``), an output gate with ``attn_gate``, a
norm after attention and after the FFN too with ``sandwich_norm``
(``attn_post_norm``, ``mlp_post_norm``), the embedding times
``embed_scale``; a moe model's ``num_dense_layers`` leading layers have a
dense FFN, stacked apart (``layers/dense_ffn``, then ``layers/ffn`` over
the MoE layers), the attention and norms stacked over every layer.

Serving (``serve_step``): a prefill of the prompt, then one-token decode
steps, against a KV cache stacked along the layer axis (one index a
layer), under ``torch.no_grad``; the cache passed in is updated in
place and returned.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as params_mod
from repro_torch.models.layers import attention, embedding, mlp, moe, norms


FAMILIES = ("dense", "moe", "vlm", "audio")


def dense_layers(cfg) -> int:
    """Leading layers whose FFN is dense in a moe model (stacked apart)."""
    return cfg.num_dense_layers if cfg.moe is not None else 0


def block_spec(cfg) -> Dict[str, Any]:
    """One layer's weights; without the FFN when dense layers lead."""
    p = {"attn_norm": norms.spec(cfg), "attn": attention.spec(cfg),
         "mlp_norm": norms.spec(cfg)}
    if cfg.sandwich_norm:
        p["attn_post_norm"] = norms.spec(cfg)
        p["mlp_post_norm"] = norms.spec(cfg)
    if not dense_layers(cfg):
        p["ffn"] = moe.spec(cfg) if cfg.moe is not None else mlp.spec(cfg)
    return p


def layers_spec(cfg) -> Dict[str, Any]:
    layers = params_mod.stack_spec(block_spec(cfg), cfg.num_layers)
    nd = dense_layers(cfg)
    if nd:
        layers["dense_ffn"] = params_mod.stack_spec(mlp.spec(cfg), nd)
        layers["ffn"] = params_mod.stack_spec(moe.spec(cfg),
                                              cfg.num_layers - nd)
    return layers


def param_specs(cfg) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": embedding.spec(cfg),
        "layers": layers_spec(cfg),
        "final_norm": norms.spec(cfg),
    }
    if not cfg.tie_embeddings:
        p["head"] = embedding.head_spec(cfg)
    return p


def block_apply(layer_params: Dict[str, Any], x: torch.Tensor, cfg, *,
                attn_chunk: int = 0, causal_skip: bool = False,
                model_axis=None, layer: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x, the MoE block's f32 aux loss, or None for a dense FFN) of
    layer ``layer``."""
    eps = cfg.norm_eps
    h = norms.apply(layer_params["attn_norm"], x, cfg.norm, eps)
    h = attention.apply_train(layer_params["attn"], h, cfg,
                              attn_chunk=attn_chunk, causal_skip=causal_skip,
                              model_axis=model_axis, layer=layer)
    if cfg.sandwich_norm:
        h = norms.apply(layer_params["attn_post_norm"], h, cfg.norm, eps)
    x = x + h
    h = norms.apply(layer_params["mlp_norm"], x, cfg.norm, eps)
    aux = None
    if cfg.moe is not None and layer >= dense_layers(cfg):
        h, aux = moe.apply(layer_params["ffn"], h, cfg,
                           model_axis=model_axis)
    else:
        h = mlp.apply(layer_params["ffn"], h, cfg, model_axis=model_axis)
    if cfg.sandwich_norm:
        h = norms.apply(layer_params["mlp_post_norm"], h, cfg.norm, eps)
    return x + h, aux


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}


def unstack(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The n layers of a stacked tree. ``unbind`` splits each stack once,
    so the backward pass stacks the per-layer gradients once instead of
    scattering each layer into a zeroed full-size stack."""
    per_layer = _unbind(tree)
    return [_layer(per_layer, i) for i in range(n)]


def layer_list(layers: Dict[str, Any], cfg) -> List[Dict[str, Any]]:
    """Each layer's weights, its FFN under 'ffn' (from the dense stack
    for the leading dense layers)."""
    nd = dense_layers(cfg)
    if not nd:
        return unstack(layers, cfg.num_layers)
    ffn = unstack(layers["dense_ffn"], nd) \
        + unstack(layers["ffn"], cfg.num_layers - nd)
    rest = {k: v for k, v in layers.items() if k not in ("dense_ffn", "ffn")}
    return [{**lp, "ffn": f}
            for lp, f in zip(unstack(rest, cfg.num_layers), ffn)]


def checkpointed(fn, x: torch.Tensor):
    """``fn(x)`` under a non-reentrant ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass. The models draw no
    random numbers, so the recompute needs no saved RNG state (reading it
    is not allowed in a CUDA graph)."""
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def backbone(params: Dict[str, Any], x: torch.Tensor, cfg, *,
             remat: str = "layer", attn_chunk: int = 0,
             causal_skip: bool = False, model_axis=None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run all layers: (hidden, the aux losses summed in layer order from
    zero, or None without MoE). Under ``model_axis`` a layer's recompute
    issues its forward all-reduces again, in the same order on every
    rank."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if cfg.moe is not None else None
    for i, lp in enumerate(layer_list(params["layers"], cfg)):
        if remat == "layer":
            x, a = checkpointed(lambda h, lp=lp, i=i: block_apply(
                lp, h, cfg, attn_chunk=attn_chunk, causal_skip=causal_skip,
                model_axis=model_axis, layer=i), x)
        else:
            x, a = block_apply(lp, x, cfg, attn_chunk=attn_chunk,
                               causal_skip=causal_skip,
                               model_axis=model_axis, layer=i)
        if a is not None:
            aux = aux + a
    return x, aux


def xent(logits: torch.Tensor, labels: torch.Tensor,
         mask: Optional[torch.Tensor] = None, model_axis=None
         ) -> torch.Tensor:
    """Mean next-token cross-entropy with f32 accumulation. Under a model
    axis that shards 'vocab' ``logits`` are this rank's block of the
    vocabulary and the cross-entropy is vocab-parallel: the max, the sum
    of exponentials and the target logit each all-reduced over the model
    group, the log-sum-exp then the JAX package's formula (the max plus
    the log of the shifted sum)."""
    lf = logits.float()
    if model_axis is not None and model_axis.sharded("vocab"):
        n = lf.shape[-1]
        m = model_axis.max_(lf.detach().amax(dim=-1))
        sumexp = model_axis.reduce_out(torch.exp(lf - m[..., None]).sum(-1))
        local = labels.long() - model_axis.index * n
        mine = (local >= 0) & (local < n)
        gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = model_axis.reduce_out(gold.masked_fill(~mine, 0.0))
        nll = torch.log(sumexp) + m - gold
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


class LanguageModel:
    """What the families' LMs share. Functional: parameters are passed
    in, not held; a subclass gives ``param_specs``, ``loss_fn``, and for
    serving ``abstract_cache`` and ``serve_step``."""

    def param_specs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16) -> Any:
        """The serving cache as (shape, dtype) pairs in its NamedTuples;
        nothing allocated."""
        raise NotImplementedError

    def cache_logical_axes(self) -> Any:
        """The cache's logical axes in its NamedTuples, the JAX
        package's ('layers' before each layer axis)."""
        raise NotImplementedError

    def serve_local(self, params: Dict[str, Any], model_axis) -> Dict[str, Any]:
        """This rank's serving weights from its blocks ``params``, made
        once before serving, so a serve step gathers no weight: the
        blocks themselves unless a family's fused weights need the
        rank's view (the Mamba blocks)."""
        return params

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Any:
        """An empty serving cache (every field zero, as in JAX) on
        ``device`` (CUDA unless given)."""
        from repro_torch import resolve_device
        return params_mod.zeros_of(self.abstract_cache(batch, max_len,
                                                       dtype),
                                   resolve_device(device))

    def serve_step(self, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], cache: Any, *,
                   mode: str = "decode",
                   compute_dtype: torch.dtype = torch.bfloat16,
                   split_combine: bool = False,
                   model_axis=None) -> Tuple[torch.Tensor, Any]:
        """(logits, cache): a prefill of batch['tokens'] (B, S) or one
        decode step of (B, 1); the cache is updated in place. Under
        ``model_axis`` (its rules the serve rules) ``params`` are the
        rank's ``serve_local`` weights and ``cache`` its blocks; the
        logits come back whole on every rank."""
        raise NotImplementedError

    def param_shapes(self) -> Dict[str, Any]:
        return params_mod.param_shapes(self.param_specs())

    def init_params(self, seed: int, device: torch.device,
                    on_device: bool = False) -> Dict[str, Any]:
        """f32 parameters from ``seed`` (``params.init_params``)."""
        return params_mod.init_params(self.param_specs(), seed, device,
                                      on_device=on_device)

    def _head_params(self, params):
        if self.cfg.tie_embeddings:
            return {"w": params["embed"]["tokens"].T}
        return params["head"]

    def _serve_logits(self, params, x: torch.Tensor, model_axis
                      ) -> torch.Tensor:
        """The head's logits, whole on every rank: a vocab-parallel
        head's blocks are gathered (one all-reduce)."""
        lg = embedding.logits(self._head_params(params), x, self.cfg,
                              model_axis=model_axis)
        if model_axis is not None and model_axis.sharded("vocab"):
            lg = model_axis.gather(lg, -1)
        return lg


class TransformerLM(LanguageModel):
    """Families: dense | moe | vlm | audio."""

    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"model family {cfg.family!r} is not a TransformerLM family "
                f"{FAMILIES}; models.build_model builds every family")
        self.cfg = cfg

    def param_specs(self) -> Dict[str, Any]:
        return param_specs(self.cfg)

    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                *, remat: str = "layer", attn_chunk: int = 0,
                causal_skip: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                model_axis=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens': (B, S) int, or (B, S, K) for audio, 'labels':
        the same}, and for the vlm 'vision_embeds' (B, V, D) float,
        prepended to the token embeddings and dropped before the head.
        ``params`` are already in the compute dtype (the trainer casts the
        f32 masters). Returns (loss + aux, {'loss', 'aux_loss'}). Under
        ``model_axis`` (``parallel.model_axis``) ``params`` are this
        rank's shards, every rank prepends the whole vision embeddings,
        and every rank returns the same loss."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)
        if cfg.embed_scale != 1.0:
            x = x * cfg.embed_scale
        vision = 0
        if cfg.family == "vlm":
            if "vision_embeds" not in batch:
                raise ValueError("a vlm batch needs 'vision_embeds' "
                                 "(B, num_vision_tokens, d_model)")
            vis = batch["vision_embeds"].to(compute_dtype)
            vision = vis.shape[1]
            x = torch.cat([vis, x], dim=1)
        x, aux = backbone(params, x, cfg, remat=remat, attn_chunk=attn_chunk,
                          causal_skip=causal_skip, model_axis=model_axis)
        x = norms.apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if vision:
            x = x[:, vision:, :]
        lg = embedding.logits(self._head_params(params), x, cfg,
                              model_axis=model_axis)
        loss = xent(lg, batch["labels"], batch.get("loss_mask"),
                    model_axis=model_axis)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss + aux, {"loss": loss, "aux_loss": aux}

    # -- serving ------------------------------------------------------------

    def _embed_inputs(self, params: Dict[str, Any],
                      batch: Dict[str, torch.Tensor],
                      compute_dtype: torch.dtype, model_axis=None
                      ) -> torch.Tensor:
        """Token embeddings; a vlm batch's 'vision_embeds' prepended when
        it has them (a serving batch may be text only)."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            x = torch.cat([batch["vision_embeds"].to(compute_dtype), x],
                          dim=1)
        return x

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> attention.KVCache:
        """k and v (L, B, max_len, KV, hd), index (L,) int32."""
        return params_mod.stack_abstract(attention.abstract_cache(
            self.cfg, batch, max_len, dtype), (self.cfg.num_layers,))

    def cache_logical_axes(self) -> attention.KVCache:
        ax = attention.cache_logical_axes()
        return attention.KVCache(k=("layers",) + ax.k, v=("layers",) + ax.v,
                                 index=("layers",))

    def _serve_block(self, layer_params: Dict[str, Any], x: torch.Tensor,
                     cache_slice: attention.KVCache, mode: str,
                     split_combine: bool = False, model_axis=None
                     ) -> Tuple[torch.Tensor, attention.KVCache]:
        cfg = self.cfg
        h = norms.apply(layer_params["attn_norm"], x, cfg.norm)
        if mode == "decode":
            h, cache_slice = attention.apply_decode(
                layer_params["attn"], h, cfg, cache_slice,
                split_combine=split_combine, model_axis=model_axis)
        else:
            h, cache_slice = attention.apply_prefill(
                layer_params["attn"], h, cfg, cache_slice, attn_chunk=2048,
                model_axis=model_axis)
        x = x + h
        h = norms.apply(layer_params["mlp_norm"], x, cfg.norm)
        if cfg.moe is not None:
            h, _ = moe.apply(layer_params["ffn"], h, cfg,
                             model_axis=model_axis)  # aux dropped
        else:
            h = mlp.apply(layer_params["ffn"], h, cfg, model_axis=model_axis)
        return x + h, cache_slice

    @torch.no_grad()
    def serve_step(self, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor],
                   cache: attention.KVCache, *, mode: str = "decode",
                   compute_dtype: torch.dtype = torch.bfloat16,
                   split_combine: bool = False, model_axis=None
                   ) -> Tuple[torch.Tensor, attention.KVCache]:
        """mode 'prefill': batch['tokens'] (B, S) (audio (B, S, K); a vlm
        may add 'vision_embeds', which take the first cache positions)
        through every layer, each writing its cache; 'decode': one token
        (B, 1) a row. Returns (logits (B, S, V), or (B, S, K, V) for
        audio, the cache passed in, updated in place). Under
        ``model_axis``: the vocab-parallel embedding, each layer's
        attention in the cache's layout (``attention.serve_layout``) and
        its MLP or MoE in their Megatron forms, the logits gathered."""
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown serve mode {mode!r}")
        cfg = self.cfg
        if cfg.layer_types or dense_layers(cfg) or cfg.sandwich_norm:
            raise NotImplementedError(
                f"{cfg.name}: serving layers that differ (windows, dense "
                f"leading layers, sandwich norms) is not written")
        x = self._embed_inputs(params, batch, compute_dtype, model_axis)
        for i, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
            x, _ = self._serve_block(lp, x, params_mod.index_struct(cache, i),
                                     mode, split_combine=split_combine,
                                     model_axis=model_axis)
        x = norms.apply(params["final_norm"], x, cfg.norm)
        return self._serve_logits(params, x, model_axis), cache

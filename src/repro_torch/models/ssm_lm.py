"""Attention-free Mamba-1 LM (the ssm family: falcon-mamba): embedding,
``num_layers`` pre-norm residual Mamba-1 blocks (stacked along a leading
L axis, the JAX package's layout), the final norm and the head.

Serving: the decode state is O(1) a layer (the conv window and the SSM
state, ``mamba.MambaState`` stacked along L), whatever the context's
length. The prefill runs the training path over the prompt and leaves
the states as they were passed in, as the JAX package's does: decoding
after it starts the recurrences from those states, not from the
prompt's."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import params as params_mod
from repro_torch.models.layers import embedding, mamba, norms
from repro_torch.models.params import index_struct, stack_abstract
from repro_torch.models.transformer import (LanguageModel, checkpointed,
                                            unstack, xent)


def block_spec(cfg) -> Dict[str, Any]:
    return {"norm": norms.spec(cfg), "mixer": mamba.spec(cfg)}


class MambaLM(LanguageModel):
    def __init__(self, cfg):
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"MambaLM needs family 'ssm' and an SSMConfig, "
                             f"got {cfg.family!r}, {cfg.ssm}")
        self.cfg = cfg

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        p: Dict[str, Any] = {
            "embed": embedding.spec(cfg),
            "layers": params_mod.stack_spec(block_spec(cfg), cfg.num_layers),
            "final_norm": norms.spec(cfg),
        }
        if not cfg.tie_embeddings:
            p["head"] = embedding.head_spec(cfg)
        return p

    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                *, remat: str = "layer", attn_chunk: int = 0,
                causal_skip: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                model_axis=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens', 'labels'} (B, S) int. ``attn_chunk`` and
        ``causal_skip`` are the Trainer's and have no attention to act on.
        Under ``model_axis`` (``parallel.model_axis``) ``params`` are this
        rank's shards and every rank returns the same loss. Returns (loss,
        {'loss', 'aux_loss': 0})."""
        del attn_chunk, causal_skip
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)

        def block(lp, h):
            return h + mamba.apply_train(
                lp["mixer"], norms.apply(lp["norm"], h, cfg.norm), cfg,
                model_axis=model_axis)

        for lp in unstack(params["layers"], cfg.num_layers):
            x = checkpointed(lambda h, lp=lp: block(lp, h), x) \
                if remat == "layer" else block(lp, x)
        x = norms.apply(params["final_norm"], x, cfg.norm)
        lg = embedding.logits(self._head_params(params), x, cfg,
                              model_axis=model_axis)
        loss = xent(lg, batch["labels"], batch.get("loss_mask"),
                    model_axis=model_axis)
        return loss, {"loss": loss, "aux_loss": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

    # -- serving ------------------------------------------------------------

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> mamba.MambaState:
        """conv (L, B, d_conv - 1, d_inner) in ``dtype``, ssm (L, B,
        d_inner, d_state) f32; ``max_len`` does not enter."""
        del max_len
        return stack_abstract(mamba.abstract_state(self.cfg, batch, dtype),
                              (self.cfg.num_layers,))

    def cache_logical_axes(self) -> mamba.MambaState:
        ax = mamba.state_logical_axes()
        return mamba.MambaState(conv=("layers",) + ax.conv,
                                ssm=("layers",) + ax.ssm)

    def serve_local(self, params: Dict[str, Any], model_axis
                    ) -> Dict[str, Any]:
        """The Mamba blocks' serving view (``mamba.serve_local``, the
        stacked mixers at once); the other leaves as they are."""
        p = dict(params)
        p["layers"] = dict(params["layers"], mixer=mamba.serve_local(
            params["layers"]["mixer"], self.cfg, model_axis))
        return p

    @torch.no_grad()
    def serve_step(self, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor],
                   cache: mamba.MambaState, *, mode: str = "decode",
                   compute_dtype: torch.dtype = torch.bfloat16,
                   split_combine: bool = False, model_axis=None
                   ) -> Tuple[torch.Tensor, mamba.MambaState]:
        """'prefill': the training path over batch['tokens'] (B, S),
        the cache returned untouched; 'decode': one token (B, 1) a row,
        each layer's state advanced in place. ``split_combine`` has no
        attention to act on. Under ``model_axis`` ``params`` are
        ``serve_local``'s and the states the rank's channels'. Returns
        (logits, the cache passed in)."""
        del split_combine
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown serve mode {mode!r}")
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype, model_axis=model_axis)
        for i, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
            y = norms.apply(lp["norm"], x, cfg.norm)
            if mode == "prefill":
                y = mamba.apply_train(lp["mixer"], y, cfg,
                                      model_axis=model_axis, prepared=True)
            else:
                y, _ = mamba.apply_decode(lp["mixer"], y, cfg,
                                          index_struct(cache, i),
                                          model_axis=model_axis)
            x = x + y
        x = norms.apply(params["final_norm"], x, cfg.norm)
        return self._serve_logits(params, x, model_axis), cache

"""Attention-free Mamba-1 LM (the ssm family: falcon-mamba), the
training path: embedding, ``num_layers`` pre-norm residual Mamba-1
blocks (stacked along a leading L axis, the JAX package's layout), the
final norm and the head."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import params as params_mod
from repro_torch.models.layers import embedding, mamba, norms
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
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens', 'labels'} (B, S) int. ``attn_chunk`` and
        ``causal_skip`` are the Trainer's and have no attention to act on.
        Returns (loss, {'loss', 'aux_loss': 0})."""
        del attn_chunk, causal_skip
        cfg = self.cfg
        x = embedding.embed(params["embed"], batch["tokens"], cfg,
                            compute_dtype)

        def block(lp, h):
            return h + mamba.apply_train(
                lp["mixer"], norms.apply(lp["norm"], h, cfg.norm), cfg)

        for lp in unstack(params["layers"], cfg.num_layers):
            x = checkpointed(lambda h, lp=lp: block(lp, h), x) \
                if remat == "layer" else block(lp, x)
        x = norms.apply(params["final_norm"], x, cfg.norm)
        lg = embedding.logits(self._head_params(params), x, cfg)
        loss = xent(lg, batch["labels"], batch.get("loss_mask"))
        return loss, {"loss": loss, "aux_loss": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

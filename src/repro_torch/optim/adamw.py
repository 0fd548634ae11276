"""Pool-space AdamW (the realistic optimizer for the transformer models),
in PyTorch. The CSC mask has SGD's meaning: unselected elements keep
their moments and weights; their gradient lives in GradientFlow's hg
buffer. Bias correction uses a per-element step count, so masked
elements correct at their own rate.

There is no kernel: the JAX package's AdamW is plain ``jnp`` too, so this
is a chain of PyTorch ops. ``update_pool`` returns new tensors; the
segment update of ``optim.update_view`` writes them back into the state
and the parameter leaves in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig


class AdamWState(NamedTuple):
    mu: torch.Tensor      # f32[pool]
    nu: torch.Tensor      # f32[pool]
    counts: torch.Tensor  # i32[pool] per-element update counts (CSC-aware)


def init(pool_size: int, device=None) -> AdamWState:
    def zeros(dtype):
        return torch.zeros((pool_size,), dtype=dtype, device=device)
    return AdamWState(mu=zeros(torch.float32), nu=zeros(torch.float32),
                      counts=zeros(torch.int32))


def update_pool(master: torch.Tensor, grads: torch.Tensor,
                state: AdamWState, mask: torch.Tensor, cfg: OptimizerConfig,
                lr, *, scale: Optional[torch.Tensor] = None,
                use_kernels: bool = False
                ) -> Tuple[torch.Tensor, AdamWState]:
    """The masked AdamW step: (new master, new state), as new tensors;
    the inputs are left as they were. ``use_kernels`` changes nothing."""
    del use_kernels
    b1, b2 = cfg.beta1, cfg.beta2
    counts = state.counts + mask.to(torch.int32)
    t = counts.clamp_min(1).to(torch.float32)
    mu = torch.where(mask, b1 * state.mu + (1 - b1) * grads, state.mu)
    nu = torch.where(mask, b2 * state.nu + (1 - b2) * torch.square(grads),
                     state.nu)
    mu_hat = mu / (1 - torch.pow(b1, t))
    nu_hat = nu / (1 - torch.pow(b2, t))
    step = lr * (mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
                 + cfg.weight_decay * master)
    if scale is not None:
        step = step * scale
    new_master = torch.where(mask, master - step, master)
    return new_master, AdamWState(mu=mu, nu=nu, counts=counts)


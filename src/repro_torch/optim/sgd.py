"""Pool-space momentum SGD with CSC masking (paper Algorithm 1, update
step), in PyTorch:

  important  : u_t = m·u_{t-1} + lr·(g_t + wd·w);  w -= u_t
  unimportant: u_t = u_{t-1};                      w unchanged

``use_kernels=True`` routes through ``kernels.ops.pool_unpack_update``
(the CUDA kernel for CUDA tensors, its plain version on the CPU). The
momentum segment and, when given, the parameter leaves are updated in
place; with the guard's device verdict ``ok`` the update kernel writes
nothing when it is false (``kernels.pool_unpack``). ``update_pool`` is
the whole-pool two-pass form (new master pool,
no unpack), through ``kernels.ops.fused_update`` with ``use_kernels``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig


class SGDState(NamedTuple):
    momentum: torch.Tensor  # f32[pool]


def init(pool_size: int, device=None) -> SGDState:
    return SGDState(momentum=torch.zeros((pool_size,), dtype=torch.float32,
                                         device=device))


def update_pool(master: torch.Tensor, grads: torch.Tensor, state: SGDState,
                mask: torch.Tensor, cfg: OptimizerConfig, lr, *,
                scale: Optional[torch.Tensor] = None,
                use_kernels: bool = False) -> Tuple[torch.Tensor, SGDState]:
    """The masked momentum-SGD step over the whole pool (per-element
    ``scale`` for LARS). Returns (new master pool, new state); the inputs
    are left as they were."""
    if use_kernels:
        from repro_torch.kernels import ops
        fn = ops.fused_update
    else:
        from repro_torch.kernels import ref
        fn = ref.fused_update
    new_master, new_mom = fn(master, grads, state.momentum, mask, lr=lr,
                             momentum=cfg.momentum,
                             weight_decay=cfg.weight_decay, scale=scale)
    return new_master, SGDState(momentum=new_mom)


def _update(offsets, sizes, specs, master, grads, state, mask, cfg, lr, *,
            scale, ratios, use_kernels, out_leaves, ok):
    if use_kernels:
        from repro_torch.kernels import ops
        fn = ops.pool_unpack_update
    else:
        from repro_torch.kernels import pool_unpack
        fn = pool_unpack.plain
    leaves, new_mom = fn(master, grads, state.momentum, mask, offsets, sizes,
                         lr=lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay, scale=scale,
                         ratios=ratios, out_leaves=out_leaves,
                         out_momentum=state.momentum, ok=ok)
    # Leaves take their declared dtype (what the JAX optimizer does).
    leaves = [x if x.dtype == spec.dtype else x.to(spec.dtype)
              for x, spec in zip(leaves, specs)]
    return leaves, SGDState(momentum=new_mom)


def update_unpack(pool, master: torch.Tensor, grads: torch.Tensor,
                  state: SGDState, mask: torch.Tensor, cfg: OptimizerConfig,
                  lr, *, scale: Optional[torch.Tensor] = None,
                  ratios: Optional[torch.Tensor] = None,
                  use_kernels: bool = False,
                  out_leaves: Optional[Sequence[torch.Tensor]] = None,
                  ok: Optional[torch.Tensor] = None,
                  ) -> Tuple[dict, SGDState]:
    """Fused update + unravel over the whole pool. Returns (new params
    tree, new state)."""
    leaves, st = _update(pool.offsets, pool.sizes, pool.specs, master,
                         grads, state, mask, cfg, lr, scale=scale,
                         ratios=ratios, use_kernels=use_kernels,
                         out_leaves=out_leaves, ok=ok)
    return pool.unflatten(leaves), st


def update_view(view, master: torch.Tensor, grads: torch.Tensor,
                state: SGDState, mask: torch.Tensor, cfg: OptimizerConfig,
                lr, *, scale: Optional[torch.Tensor] = None,
                ratios: Optional[torch.Tensor] = None,
                use_kernels: bool = False,
                out_leaves: Optional[Sequence[torch.Tensor]] = None,
                ok: Optional[torch.Tensor] = None,
                ) -> Tuple[List[torch.Tensor], SGDState]:
    """``update_unpack`` on one bucket-aligned span: every array is a
    span-relative segment, driven by the view's rebased segment table.
    Returns (1-D leaves of the view's tensors, new momentum segment)."""
    return _update(view.offsets, view.sizes, view.specs, master, grads,
                   state, mask, cfg, lr, scale=scale, ratios=ratios,
                   use_kernels=use_kernels, out_leaves=out_leaves, ok=ok)

"""LARS — layer-wise adaptive rate scaling (paper §4.2, You et al.), in
PyTorch.

In pool space LARS is a per-tensor learning-rate scale:

    local_lr(tensor) = eta * ||w|| / (||g|| + wd * ||w|| + eps)

or 1.0 where either norm is 0. A "tensor" is a pool leaf (smollm-135m
stacks its layers, so 11 leaves and 11 ratios), as in the JAX package.
Under CSC, ||g|| is the norm of the masked gradient: unselected chunks
count as zero, as they receive no update this iteration.

Every ratio stays on the device (``torch.where``, no ``.item()``): a host
sync per leaf would stall the staged pipeline that overlaps bucket i's
collective with bucket i-1's update. The norms are plain PyTorch
reductions in f32; the JAX package has no kernel for them either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels import ref


class LARSScaler:
    """Per-tensor trust ratios over the pool's segment table."""

    def __init__(self, pool):
        self.pool = pool

    @staticmethod
    def _span_ratios(master: torch.Tensor, g: torch.Tensor,
                     cfg: OptimizerConfig, offsets: Sequence[int],
                     sizes: Sequence[int]) -> torch.Tensor:
        """f32[len(sizes)]: one trust ratio per (offset, size) span of the
        given buffers, the shared math of the pool and view variants."""
        if not sizes:
            return torch.zeros((0,), dtype=torch.float32,
                               device=master.device)
        w_norm = torch.stack([torch.linalg.vector_norm(master[o:o + s])
                              for o, s in zip(offsets, sizes)])
        g_norm = torch.stack([torch.linalg.vector_norm(g[o:o + s])
                              for o, s in zip(offsets, sizes)])
        ratio = cfg.lars_eta * w_norm / (
            g_norm + cfg.weight_decay * w_norm + cfg.lars_eps)
        return torch.where((w_norm > 0.0) & (g_norm > 0.0), ratio, 1.0)

    @staticmethod
    def _masked(grads: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        return grads if mask is None else torch.where(mask, grads, 0.0)

    def ratios(self, master: torch.Tensor, grads: torch.Tensor,
               cfg: OptimizerConfig,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32[num_tensors] trust ratios, plus a trailing 1.0 for the
        pool's padding when it has some."""
        r = self._span_ratios(master, self._masked(grads, mask), cfg,
                              self.pool.offsets, self.pool.sizes)
        if self.pool.padding:
            r = torch.cat([r, r.new_ones((1,))])
        return r

    def ratios_view(self, view, master_seg: torch.Tensor,
                    grads_seg: torch.Tensor, cfg: OptimizerConfig,
                    mask_seg: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The trust ratios of one bucket view's tensors, from span-relative
        segments. Buckets close at tensor boundaries, so each tensor's
        norms are complete inside its bucket. No padding entry: the update
        pads with 1.0 itself; a view with no leaf gives an empty vector."""
        return self._span_ratios(master_seg,
                                 self._masked(grads_seg, mask_seg), cfg,
                                 view.offsets, view.sizes)

    def expand(self, ratios: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Per-tensor ratios -> the pool-sized per-element scale (the path
        without the update kernel; the kernel takes ``ratios`` itself)."""
        return ref.expand_ratios(ratios, self.pool.sizes,
                                 self.pool.size).to(dtype)

    def scale(self, master: torch.Tensor, grads: torch.Tensor,
              cfg: OptimizerConfig,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pool-sized per-element scale (``ratios`` + ``expand``)."""
        return self.expand(self.ratios(master, grads, cfg, mask),
                           dtype=master.dtype)

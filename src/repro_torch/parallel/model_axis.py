"""The model axis (tensor parallelism) as the model sees it.

The JAX package shards a dense model over its mesh's 'model' axis by
declaring each weight's logical axes and letting GSPMD place the
collectives. The port writes Megatron's form by hand: ``ModelAxis`` holds
this rank's model group, its size and index, and the architecture's rule
table; the layers ask it which weights are sharded (``sharded``) and put
its two conjugate operators around each parallel region:

* ``copy_in`` (Megatron's f): identity forward, all-reduce of the
  gradient backward; the entry of a column-parallel product, whose input
  every model rank holds whole;
* ``reduce_out`` (Megatron's g): all-reduce forward, identity backward;
  the exit of a row-parallel product, or of any per-rank partial sum.

and two more built on the same all-reduce:

* ``all_sum`` (g then f): all-reduce forward and backward; a per-rank
  partial sum that every rank then uses on its own share of the work
  (Mamba-1's ``x_proj`` output, Mamba-2's sum of squares over the inner
  width), so each rank's gradient of the sum is partial too;
* ``gather``: the whole of a tensor held in contiguous blocks, one a
  rank (each block placed in zeros and all-reduced); backward the
  gradient all-reduced and this rank's block kept. For a leaf whose
  block is not the slice of the work its rank does (a fused input
  projection cut across its parts) and for KV heads that do not split.

Both are ``torch.autograd.Function``s, so a per-layer remat
(``torch.utils.checkpoint``) issues a region's forward all-reduces again
in the recompute, in the same order on every rank.

On the card the model group is a gloo group: NCCL refuses two ranks on
one device, and the mesh's model ranks share the card. A CUDA tensor is
staged through a pinned host buffer (a device-to-host copy, the stream
synchronised, gloo's sum on the host, the copy back); that is the
transport, not a fallback. Each all-reduce runs in a ``comm.all_reduce``
span and is counted in ``runtime.trace``'s ``model_axis`` group
(``all_reduces``, ``bytes``), over every model group of the process.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import trace


class ModelAxis:
    def __init__(self, group, size: int, index: int,
                 rules: Mapping[str, Optional[str]]):
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.rules = dict(rules)
        self._host: Dict[Tuple[torch.dtype, int], torch.Tensor] = {}

    def sharded(self, axis: str) -> bool:
        """Does the rule table put logical axis ``axis`` on the model
        axis (and does the axis have more than one rank)?"""
        return self.size > 1 and self.rules.get(axis) == "model"

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        """Reduce ``x`` (contiguous) in place over the model group."""
        if self.size == 1:
            return x
        counts = trace.counters["model_axis"]
        counts["all_reduces"] += 1
        counts["bytes"] += x.numel() * x.element_size()
        with trace.span("comm.all_reduce"):
            if x.is_cuda and dist.get_backend(self.group) != "nccl":
                key = (x.dtype, x.numel())
                host = self._host.get(key)
                if host is None:
                    host = self._host[key] = torch.empty(
                        (x.numel(),), dtype=x.dtype, pin_memory=True)
                flat = x.view(-1)
                host.copy_(flat, non_blocking=True)
                torch.cuda.current_stream(x.device).synchronize()
                dist.all_reduce(host, op=op, group=self.group)
                # Ordered on the stream before the next call's copy into
                # ``host``, which waits for that stream before gloo
                # writes.
                flat.copy_(host, non_blocking=True)
            else:
                dist.all_reduce(x, op=op, group=self.group)
        return x

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: identity forward, gradient all-reduced backward."""
        return _CopyIn.apply(x, self) if self.size > 1 else x

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: all-reduce forward, identity backward."""
        return _ReduceOut.apply(x, self) if self.size > 1 else x

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The model-group sum of per-rank partials, used whole by every
        rank on its share of the work: all-reduce forward, the gradient
        all-reduced backward."""
        return self.copy_in(self.reduce_out(x)) if self.size > 1 else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of which ``x`` is this rank's block along
        ``dim`` (``size`` equal contiguous blocks, rank r's the r-th)."""
        return _Gather.apply(x, self, dim % x.dim()) if self.size > 1 \
            else x

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` items split ``size`` ways."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the model group, in place (no
        gradient)."""
        return self.all_reduce_(x, op=dist.ReduceOp.MAX)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= axis.size
        full = x.new_zeros(shape)
        full.narrow(dim, axis.index * ctx.n, ctx.n).copy_(x)
        return axis.all_reduce_(full)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.axis.all_reduce_(grad.contiguous().clone())
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None

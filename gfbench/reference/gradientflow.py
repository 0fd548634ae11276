"""GradientFlow's step after the backward pass (arXiv:1902.06855), the
plain reference: the gradient pool, the wire, the all-reduce, coarse-
grained sparse communication (CSC) and the momentum-SGD update of
Algorithm 1, in plain PyTorch on whole tensors.

* The pool holds every gradient, contiguous, in generation order: the
  reverse of the weights' sorted names. CSC pads it with zeros to whole
  chunks.
* Lazy (and dense) all-reduce: each rank's gradient rounded to the wire
  dtype, summed over the ranks, divided by their number. How the sum is
  cut into buckets changes nothing but the order of its additions.
* CSC (Algorithm 1): this rank's unsent gradients ``hg`` are added, the
  top k = round((1 - sparsity) C) of the C chunks by the previous step's
  per-chunk L1 norms summed over the ranks are chosen (ties to the lower
  chunk; before the first step the norms descend with the chunk id), and
  only those are rounded to the wire and averaged. ``hg`` keeps the
  momentum-scaled gradient of the chunks not sent; the next norms are
  the per-chunk L1 of the averaged chunks and of this rank's own
  elsewhere, summed over the ranks.
* Momentum SGD where the mask holds (all of the pool outside CSC):
  u = m u + lr (g + wd w); w = w - u.
* The learning rate: linear warm-up, then cosine decay, in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def lr_at(opt: Dict, step: int) -> torch.Tensor:
    """The learning rate of ``step`` as a float32 scalar."""
    f32 = torch.float32
    t = torch.tensor(float(step), dtype=f32)
    warm = torch.tensor(float(max(opt["warmup_steps"], 1)), dtype=f32)
    total = torch.tensor(float(max(opt["total_steps"], 1)), dtype=f32)
    frac = torch.clamp((t + 1.0) / warm, max=1.0)
    progress = torch.clamp((t - warm) / torch.clamp(total - warm, min=1.0),
                           0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                 * progress))
    return torch.tensor(opt["learning_rate"], dtype=f32) * frac * cos


class Pool:
    """The layout of the gradient pool over named weights."""

    def __init__(self, shapes: Dict[str, Sequence[int]], pad_to: int = 1):
        self.order = sorted(shapes)[::-1]
        self.shapes = {n: tuple(shapes[n]) for n in self.order}
        self.offsets: Dict[str, int] = {}
        pos = 0
        for n in self.order:
            self.offsets[n] = pos
            pos += math.prod(self.shapes[n])
        self.used = pos
        self.size = -(-pos // pad_to) * pad_to

    def pack(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        flat = [tensors[n].reshape(-1).float() for n in self.order]
        if self.size > self.used:
            flat.append(flat[0].new_zeros(self.size - self.used))
        return torch.cat(flat)

    def leaf(self, pool: torch.Tensor, name: str) -> torch.Tensor:
        o = self.offsets[name]
        return pool[o:o + math.prod(self.shapes[name])].view(self.shapes[name])


class Backend:
    """One rank's reduce (lazy or CSC) and update, on the pool."""

    def __init__(self, pool: Pool, gf: Dict, opt: Dict, world: int,
                 device, exchange: bool = True):
        self.pool, self.gf, self.opt = pool, gf, opt
        self.world, self.exchange = world, exchange
        self.wire = getattr(torch, gf["wire_dtype"])
        self.mode = gf["mode"]
        if self.mode not in ("lazy", "dense", "csc"):
            raise ValueError(f"unknown GradientFlow mode {self.mode!r}")
        n = pool.size
        self.momentum = torch.zeros(n, device=device)
        if self.mode == "csc":
            self.chunk = gf["chunk_elems"]
            c = n // self.chunk
            self.k = min(max(int(round((1.0 - gf["sparsity"]) * c)), 1), c)
            self.hg = torch.zeros(n, device=device)
            self.norms = torch.arange(c, 0, -1, dtype=torch.float32,
                                      device=device)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.world > 1 and self.exchange:
            dist.all_reduce(x)
        return x

    def reduce(self, grads: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the averaged gradient the update reads, its bool mask or None
        for the whole pool) from this rank's f32 gradient pool."""
        if self.mode != "csc":
            return self._sum(grads.to(self.wire).float()) / self.world, None
        g = grads + self.hg
        c = self.norms.shape[0]
        order = torch.sort(self.norms, descending=True, stable=True).indices
        idx = torch.sort(order[:self.k]).values
        chunk_mask = torch.zeros(c, dtype=torch.bool, device=g.device)
        chunk_mask[idx] = True
        rows = g.view(c, self.chunk)
        sent = self._sum(rows[idx].to(self.wire).float()) / self.world
        out = rows.clone()
        out[idx] = sent
        mask = chunk_mask[:, None].expand(c, self.chunk).reshape(-1)
        update = torch.zeros_like(g).view(c, self.chunk)
        update[idx] = sent
        self.hg = torch.where(mask, 0.0, self.gf["momentum"] * out.view(-1))
        self.norms = out.abs().sum(dim=1)
        if self.world > 1:
            dist.all_reduce(self.norms)
        return update.view(-1), mask

    def update(self, w: torch.Tensor, g: torch.Tensor,
               mask: Optional[torch.Tensor], lr: torch.Tensor) -> torch.Tensor:
        """Momentum SGD on the weight pool ``w``; returns the new pool and
        keeps the new momentum."""
        opt = self.opt
        step = g + opt["weight_decay"] * w
        u = opt["momentum"] * self.momentum + lr * step
        if mask is None:
            self.momentum = u
            return w - u
        self.momentum = torch.where(mask, u, self.momentum)
        return torch.where(mask, w - u, w)


def pool_grads(loss_fn, w: Dict[str, torch.Tensor], pool: Pool,
               tokens: torch.Tensor, labels: torch.Tensor,
               block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, f32 gradient pool) of this rank's rows, computed
    ``block_rows`` rows at a time: each block's mean loss weighted by its
    share of the rows."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in w.items()}
    rows = tokens.shape[0]
    total = torch.zeros((), device=tokens.device)
    for s in range(0, rows, block_rows):
        e = min(s + block_rows, rows)
        part = loss_fn(leaves, tokens[s:e], labels[s:e]) * ((e - s) / rows)
        part.backward()
        total = total + part.detach()
    grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
             for n, t in leaves.items()}
    return total, pool.pack(grads)


def unpack(pool: Pool, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {n: pool.leaf(flat, n) for n in pool.order}


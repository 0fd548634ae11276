"""Gradient memory pool (paper §3.1, Figure 15), in PyTorch.

All gradient tensors live in one contiguous 1-D pool in *generation
order*: the backward pass produces the top layers first, so the pool is
the reverse of the parameter tree's flatten order. The tree is a nested
``dict`` flattened with sorted keys — JAX's order, and not the order of
``named_parameters()`` — so the segment table (names, offsets, sizes,
padding) is the JAX package's table entry for entry. Layer weights are
stacked ``(L, ...)`` tensors, one leaf each.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.runtime import trace

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Metadata for one gradient tensor inside the pool."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int
    offset: int  # start offset in the pool, in elements


@dataclasses.dataclass(frozen=True)
class PoolView:
    """Bucket-aligned view of a pool span ``[start, end)``: the
    segment-table rows inside it, offsets rebased to ``start``."""

    start: int
    end: int
    leaf_lo: int
    leaf_hi: int
    specs: Tuple[LeafSpec, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    padding: int

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def num_tensors(self) -> int:
        return self.leaf_hi - self.leaf_lo


def flatten_tree(tree: Tree, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], Any]]:
    """Nested dict -> [(key path, leaf)] in JAX's order (sorted keys). An
    empty subtree has no leaf; ``tree_def`` keeps it."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(flatten_tree(value, prefix + (key,)))
        else:
            out.append((prefix + (key,), value))
    return out


def tree_def(tree: Tree) -> Tree:
    """The tree's structure, as JAX's treedef holds it: nested dicts in
    sorted-key order with None at the leaves, empty subtrees kept (a
    non-parametric norm's ``{}``)."""
    return {k: tree_def(v) if isinstance(v, dict) else None
            for k, v in sorted(tree.items())}


def unflatten_tree(treedef: Tree, leaves: Sequence[Any]) -> Tree:
    """Inverse of ``flatten_tree`` against ``tree_def`` of the same tree:
    ``leaves`` in ``flatten_tree``'s order; empty subtrees come back as
    ``{}``."""
    it = iter(leaves)
    end = object()

    def walk(node: Tree) -> Tree:
        out: Tree = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                leaf = next(it, end)
                if leaf is end:
                    raise ValueError("fewer leaves than the tree holds")
                out[k] = leaf
        return out

    tree = walk(treedef)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return tree


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return tuple(int(d) for d in leaf), torch.float32


class GradientPool:
    """Bidirectional map between a parameter/gradient tree and the 1-D
    pool. Built from a nested dict of tensors or of shapes (tuples or
    ``torch.Size``, taken as float32), so the full-size table needs no
    allocation. The pool is padded to a multiple of ``pad_to``."""

    def __init__(self, params: Tree, pad_to: int = 1):
        flat = flatten_tree(params)
        ordered = list(reversed(flat))
        self._treedef = tree_def(params)
        specs: List[LeafSpec] = []
        offset = 0
        for path, leaf in ordered:
            shape, dtype = _shape_dtype(leaf)
            size = math.prod(shape)
            specs.append(LeafSpec(name="/".join(path), shape=shape,
                                  dtype=dtype, size=size, offset=offset))
            offset += size
        self.specs: Tuple[LeafSpec, ...] = tuple(specs)
        self.unpadded_size = offset
        self.pad_to = max(int(pad_to), 1)
        self.padding = (self.pad_to - offset % self.pad_to) % self.pad_to
        self.size = offset + self.padding
        self.offsets: Tuple[int, ...] = tuple(s.offset for s in self.specs)
        self.sizes: Tuple[int, ...] = tuple(s.size for s in self.specs)

    @property
    def num_tensors(self) -> int:
        return len(self.specs)

    # -- tree <-> 1-D leaves ------------------------------------------------

    def flat_leaves(self, tree: Tree) -> List[torch.Tensor]:
        """Tree -> 1-D leaves in pool order, with shape checks."""
        leaves = [leaf for _, leaf in reversed(flatten_tree(tree))]
        if len(leaves) != len(self.specs):
            raise ValueError(f"pool built for {len(self.specs)} leaves, got "
                             f"{len(leaves)}")
        out = []
        for leaf, spec in zip(leaves, self.specs):
            if tuple(leaf.shape) != spec.shape:
                raise ValueError(f"{spec.name}: expected {spec.shape}, got "
                                 f"{tuple(leaf.shape)}")
            out.append(leaf.reshape(-1))
        return out

    def unflatten(self, leaves_1d: Sequence[torch.Tensor]) -> Tree:
        """1-D leaves in pool order -> tree (inverse of flat_leaves), with
        the structure the pool was built from, empty subtrees included."""
        assert len(leaves_1d) == len(self.specs)
        shaped = [x.reshape(spec.shape)
                  for x, spec in zip(leaves_1d, self.specs)]
        return unflatten_tree(self._treedef, list(reversed(shaped)))

    # -- pack / unravel -----------------------------------------------------

    def pack(self, grads: Tree, dtype: Optional[torch.dtype] = None, *,
             norms_chunk: int = 0, use_kernels: bool = False,
             out: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Tree -> (1-D pool in ``dtype``, optional f32 per-chunk L1 norms
        of the packed values), one pass. ``use_kernels`` routes through
        ``kernels.ops.pool_pack`` (the CUDA kernel for CUDA tensors)."""
        return self._pack(grads, dtype, norms_chunk, use_kernels, out)

    def pack_into(self, out: torch.Tensor, grads: Tree,
                  dtype: Optional[torch.dtype] = None, *,
                  norms_chunk: int = 0, use_kernels: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor]:
        """Pack into the wire-dtype staging buffer ``out`` in place and
        return (pool, norms, staging) so the caller can hand the buffer to
        the next step; the pool is the staging buffer."""
        pool, norms = self._pack(grads, dtype, norms_chunk, use_kernels, out)
        return pool, norms, pool

    def _pack(self, grads, dtype, norms_chunk, use_kernels, out):
        leaves = self.flat_leaves(grads)
        if dtype is None:
            dtype = ref.result_dtype(leaves) if leaves else torch.float32
        if norms_chunk:
            assert self.size % norms_chunk == 0, (self.size, norms_chunk)
        with trace.span("gf.pack"):
            if use_kernels:
                from repro_torch.kernels import ops
                return ops.pool_pack(leaves, self.offsets, self.sizes,
                                     self.size, norms_chunk, dtype, out=out)
            return ref.pool_pack(leaves, self.offsets, self.size,
                                 norms_chunk, dtype, out=out)

    def unravel(self, pool: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> Tree:
        """1-D pool -> tree (drops padding); leaves are views of the pool
        unless a cast is needed."""
        leaves = []
        for spec in self.specs:
            x = pool[spec.offset:spec.offset + spec.size]
            target = dtype if dtype is not None else spec.dtype
            leaves.append(x if x.dtype == target else x.to(target))
        return self.unflatten(leaves)

    # -- bucketing for lazy allreduce ---------------------------------------

    def bucket_boundaries(self, bucket_elems: int) -> List[Tuple[int, int]]:
        """θ-bucketing: buckets close at the first tensor boundary at or
        after every θ elements; ``bucket_elems <= 0`` means one bucket."""
        if bucket_elems <= 0 or bucket_elems >= self.size:
            return [(0, self.size)]
        bounds: List[Tuple[int, int]] = []
        start = 0
        acc = 0
        for spec in self.specs:
            acc += spec.size
            if acc - start >= bucket_elems:
                bounds.append((start, acc))
                start = acc
        if start < self.size:
            bounds.append((start, self.size))
        return bounds

    def leaf_range(self, start: int, end: int) -> Tuple[int, int]:
        """Segment-table rows [lo, hi) of the tensors inside the
        tensor-aligned span ``[start, end)``."""
        assert 0 <= start <= end <= self.size, (start, end, self.size)
        lo = bisect.bisect_left(self.offsets, start)
        if lo == len(self.offsets) or self.offsets[lo] != start:
            assert start >= self.unpadded_size, (
                f"bucket start {start} is not a tensor boundary")
            lo = len(self.specs)
        hi = bisect.bisect_left(self.offsets, end, lo)
        if hi > lo:
            last = self.specs[hi - 1]
            assert last.offset + last.size <= end, (
                f"bucket end {end} is not a tensor boundary")
        return lo, hi

    def bucket_view(self, start: int, end: int) -> PoolView:
        lo, hi = self.leaf_range(start, end)
        specs = self.specs[lo:hi]
        covered = (specs[-1].offset + specs[-1].size) if specs else start
        return PoolView(
            start=start, end=end, leaf_lo=lo, leaf_hi=hi, specs=specs,
            offsets=tuple(s.offset - start for s in specs),
            sizes=tuple(s.size for s in specs),
            padding=end - covered)

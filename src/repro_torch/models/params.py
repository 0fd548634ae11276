"""Parameter declarations and initialisers.

Every parameter is declared as a ``ParamSpec`` (shape, logical axes,
initialiser), as in the JAX package. The axes are the JAX package's
logical names ('vocab', 'embed', 'qkv', 'mlp', 'expert', 'dinner', ...;
'layers' for a stacked layer axis, None for an unnamed one), leaf for
leaf; they say nothing of a mesh by themselves: only
``parallel.sharding`` maps them, through an architecture's rule table,
to the model axis. ``init_params`` materialises a nested dict of f32
tensors from a seeded ``torch.Generator`` on the CPU and moves them to the
device, so the same seed gives the same weights on every device. With
``on_device=True`` it draws on the target device instead: much faster at
billions of parameters (the CPU draw takes ~10 s a billion), but the
bits are that device's generator's. The generator's bits are not
``jax.random``'s: tests that compare the two packages carry weights
across with ``repro_torch.convert``.

A serving cache is declared the same way, as (shape, dtype) pairs in its
NamedTuples (``stack_abstract`` adds the layer axes, ``zeros_of``
materialises it, ``index_struct`` takes one layer's views).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Init = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]


def normal_init(stddev: float) -> Init:
    def f(gen, shape):
        return torch.randn(shape, generator=gen, device=gen.device) * stddev
    return f


def ones_init(gen, shape):
    return torch.ones(shape, device=gen.device)


def zeros_init(gen, shape):
    return torch.zeros(shape, device=gen.device)


def full_init(value: float) -> Init:
    def f(gen, shape):
        return torch.full(shape, value, device=gen.device)
    return f


def fan_in_init(fan_axis: int = 0) -> Init:
    def f(gen, shape):
        fan_in = shape[fan_axis] if shape else 1
        return torch.randn(shape, generator=gen, device=gen.device) \
            / math.sqrt(max(fan_in, 1))
    return f


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape, one logical axis name (or None) a
    dimension, and its initialiser."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: Init = fan_in_init(0)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn: Callable[[ParamSpec], Any], tree: Dict[str, Any]
              ) -> Dict[str, Any]:
    return {k: map_specs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stack_spec(tree: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Add a leading (n,) 'layers' axis; each layer is initialised as its
    own unstacked tensor."""
    def wrap(s: ParamSpec) -> ParamSpec:
        def stacked(gen, shape, base=s.init):
            return torch.stack([base(gen, shape[1:]) for _ in range(shape[0])])
        return ParamSpec((n,) + s.shape, ("layers",) + s.axes, stacked)
    return map_specs(wrap, tree)


def init_params(specs: Dict[str, Any], seed: int, device: torch.device,
                on_device: bool = False) -> Dict[str, Any]:
    """Materialise f32 parameters, leaves drawn in sorted-key order from a
    generator on the CPU (or, ``on_device``, on ``device``)."""
    gen = torch.Generator(device=device if on_device else "cpu") \
        .manual_seed(seed)

    def walk(tree):
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else tree[k].init(gen, tree[k].shape).to(torch.float32)
                .to(device) for k in sorted(tree)}
    return walk(specs)


def param_shapes(specs: Dict[str, Any]) -> Dict[str, Any]:
    return map_specs(lambda s: s.shape, specs)


def _is_struct(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def stack_abstract(tree: Any, lead: Tuple[int, ...]) -> Any:
    """A cache's (shape, dtype) pairs, nested in its NamedTuples, with
    ``lead`` prepended to every shape (the layer axes)."""
    if _is_struct(tree):
        return type(tree)(*(stack_abstract(t, lead) for t in tree))
    shape, dtype = tree
    return (lead + tuple(shape), dtype)


def zeros_of(tree: Any, device: torch.device) -> Any:
    """Zero tensors for a cache's (shape, dtype) pairs, in its
    NamedTuples."""
    if _is_struct(tree):
        return type(tree)(*(zeros_of(t, device) for t in tree))
    shape, dtype = tree
    return torch.zeros(shape, dtype=dtype, device=device)


def index_struct(tree: Any, i: int) -> Any:
    """Entry i of a stacked cache: views, so writes land in the stack."""
    if _is_struct(tree):
        return type(tree)(*(index_struct(t, i) for t in tree))
    return tree[i]

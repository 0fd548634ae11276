"""In-band gradient health detection: the numeric guard rail's flags and
its atomic commit, in PyTorch.

The reduce path already produces an f32 L1 census, and that census is
the health channel: ``|NaN|`` is NaN and ``|Inf|`` is Inf, so a
non-finite gradient element poisons its chunk's (or bucket's) sum, and
a finite sum near the wire dtype's max means the mixed-precision wire is
about to saturate.

* Dense and lazy: each bucket's ``health_word`` is the L1 of its
  *reduced* mean. The all-reduce has mixed every rank's contribution, so
  a poison injected on one rank reaches every rank with the payload and
  the verdict is the same everywhere without an extra collective.
* CSC: the summed chunk census that selection needs anyway
  (``csc.summed_census``) is inspected directly.

Under a model axis each rank's verdict reads its local pool only, so a
poison inside one rank's block of a sharded leaf would trip that rank
alone. ``group_verdict`` takes the flags' max over the model group (one
small all-reduce a guarded step) before the commit reads them: every
rank of the group then commits or skips together and their loss
scalers stay equal. The JAX package takes each shard's verdict from its
own pool (a departure, ROADMAP.md C); where its shards agree the two
give the same result.

The commit: the JAX package selects between the new and the old state
with a ``where`` or a ``lax.cond``. The port updates in place, so a
tripped step is predication on a device flag instead: the update kernel
takes ``ok`` and writes nothing when it is false
(``kernels.pool_unpack``), and the state no kernel writes (CSC's ``hg``
and ``chunk_norms``, AdamW's moments and leaves) goes through
``commit_where``. The verdict stays a device tensor: nothing in a step
waits on the host for it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import GuardConfig
from repro_torch.kernels import ref


class HealthFlags(NamedTuple):
    """The step's verdict: two 0-dim bool tensors, the same on every
    rank."""

    nonfinite: torch.Tensor  # any NaN/Inf in the reduced payload
    overflow: torch.Tensor   # a finite census entry at or above the limit


def overflow_limit(cfg: GuardConfig, wire_dtype) -> float:
    """The census threshold of the overflow flag: ``overflow_fraction`` of
    the wire dtype's max for wide-exponent wires (bf16, f32). A narrow
    wire (f16, max 65504) has no gap between an honest bucket L1 and its
    max, so the check is off (inf) and saturation shows as the Inf the
    wire cast makes, through the nonfinite flag."""
    if isinstance(wire_dtype, str):
        wire_dtype = getattr(torch, wire_dtype)
    fmax = float(torch.finfo(wire_dtype).max)
    if fmax < 1e30:
        return float("inf")
    return fmax * cfg.overflow_fraction


def per_chunk_limit(scale_census: torch.Tensor, cfg: GuardConfig,
                    absolute_limit: float) -> torch.Tensor:
    """Per-chunk limits for the quantized wires: ``1 / overflow_fraction``
    times the chunk's census basis, capped by ``absolute_limit``; a chunk
    with a zero basis (padding, dead parameters) gets only the absolute
    limit."""
    basis = scale_census.to(torch.float32)
    rel = torch.where(basis > 0, basis / cfg.overflow_fraction,
                      torch.inf)
    return torch.clamp_max(rel, absolute_limit)


def health_word(seg: torch.Tensor) -> torch.Tensor:
    """One bucket's health word: ``sum |x|`` in f32 (a 0-dim tensor). NaN
    elements make it NaN, Inf elements Inf, a near-saturated wire huge.
    A PyTorch reduction, as it is ``jnp`` outside any kernel in the JAX
    package; ``vector_norm`` reads the segment once without an ``abs``
    temporary."""
    return torch.linalg.vector_norm(seg, ord=1, dtype=torch.float32)


def flags_from_census(census: torch.Tensor,
                      limit: Union[float, torch.Tensor]) -> HealthFlags:
    """Fold a census vector (health words, or CSC's chunk norms) into the
    verdict. ``limit`` is a float (compared as f32, and passed to the
    device as a kernel argument, not copied there) or a per-chunk
    tensor."""
    finite = torch.isfinite(census)
    return HealthFlags(nonfinite=(~finite).any(),
                       overflow=(finite & (census >= limit)).any())


def flags_from_words(words: Sequence[torch.Tensor],
                     limit: float) -> HealthFlags:
    return flags_from_census(torch.stack(list(words)), limit)


def tripped(flags: HealthFlags) -> torch.Tensor:
    return flags.nonfinite | flags.overflow


def group_verdict(flags: HealthFlags, model_axis=None
                  ) -> Tuple[HealthFlags, torch.Tensor]:
    """(flags, ok) of a verdict site: ``flags`` as they are, or, under a
    model axis of more than one rank, each flag the max over the model
    group (``ModelAxis.max_``, counted as one of its all-reduces); ``ok``
    is the commit predicate ``~tripped(flags)``."""
    if model_axis is not None and model_axis.size > 1:
        both = model_axis.max_(torch.stack(flags).to(torch.float32))
        flags = HealthFlags(nonfinite=both[0] > 0, overflow=both[1] > 0)
    return flags, ~tripped(flags)


def as_metrics(flags: HealthFlags) -> dict:
    """The verdict as the step's ``guard_tripped`` metric (f32, like the
    other metrics)."""
    return {"guard_tripped": tripped(flags).to(torch.float32)}


# The atomic commit of state no kernel writes (CSC's hg and chunk norms,
# AdamW's moments, counts and leaves): each old tensor takes its new value
# where the device flag holds and keeps its bits otherwise. The same
# select is the plain form of the update kernel's ``ok`` predicate.
commit_where = ref.commit_where

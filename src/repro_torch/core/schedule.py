"""Warm-up dense training schedule for CSC (paper §3.2).

The port's own copy of the JAX package's ``core/schedule.py`` (pure
Python; the tests hold the two against each other). During the first
``warmup_steps`` iterations the sparsity ratio ramps linearly from 0 to
the final value, quantized into ``warmup_stages`` discrete stages, each
with a static number of transmitted chunks; the trainer builds one step
function per stage. After warm-up a single steady-state stage runs.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Iterator, List, Tuple

from repro_torch.configs.base import GradientFlowConfig


@dataclasses.dataclass(frozen=True)
class SparsityStage:
    """One compiled stage of the warm-up ramp."""

    index: int
    first_step: int
    sparsity: float
    num_selected: int  # k — static number of transmitted chunks


def build_stages(cfg: GradientFlowConfig, num_chunks: int) -> List[SparsityStage]:
    """Quantized linear ramp 0 → cfg.sparsity over cfg.warmup_steps."""
    if not cfg.csc_enabled:
        return [SparsityStage(0, 0, 0.0, num_chunks)]
    stages: List[SparsityStage] = []
    n_warm = max(int(cfg.warmup_stages), 1) if cfg.warmup_steps > 0 else 0
    for i in range(n_warm):
        frac = i / n_warm
        sparsity = cfg.sparsity * frac
        k = num_selected_chunks(sparsity, num_chunks)
        first = int(round(cfg.warmup_steps * frac))
        stages.append(SparsityStage(i, first, sparsity, k))
    k_final = num_selected_chunks(cfg.sparsity, num_chunks)
    stages.append(
        SparsityStage(n_warm, cfg.warmup_steps, cfg.sparsity, k_final))
    return stages


def num_selected_chunks(sparsity: float, num_chunks: int) -> int:
    """k = chunks transmitted at a given sparsity ratio (at least 1)."""
    k = int(round((1.0 - sparsity) * num_chunks))
    return min(max(k, 1), num_chunks)


def stage_first_steps(stages: List[SparsityStage]) -> tuple:
    """The bisect keys for ``stage_at``: build ONCE per stage list and
    pass to every lookup (GradientFlow caches this at construction) —
    otherwise the key-list build costs the same O(stages) per call the
    bisect was meant to remove."""
    return tuple(s.first_step for s in stages)


def stage_at(stages: List[SparsityStage], step: int,
             first_steps: tuple = None) -> SparsityStage:
    """The stage active at ``step`` (host-side; selects the step function).

    ``build_stages`` emits ``first_step`` in nondecreasing order, so the
    active stage is the rightmost one whose ``first_step <= step`` — a
    ``bisect`` over the keys. Hot loops pass the precomputed
    ``first_steps`` (see ``stage_first_steps``) for O(log stages) per
    lookup; without it the key list is rebuilt per call."""
    firsts = first_steps if first_steps is not None \
        else stage_first_steps(stages)
    i = bisect.bisect_right(firsts, step) - 1
    return stages[max(i, 0)]


def snap_stages_to_window(stages: List[SparsityStage],
                          window: int) -> List[SparsityStage]:
    """Snap each stage's ``first_step`` to the nearest multiple of
    ``window`` (the length K of a K-step window) so no window ever
    straddles a stage boundary — each window then runs under exactly one
    stage's step function.

    Stage 0 stays pinned at 0 and the snapped ``first_step`` sequence is
    kept nondecreasing. Two stages may snap onto the same step; the
    later one wins every ``stage_at`` lookup (``bisect_right`` picks the
    rightmost), so the shadowed stage simply never executes — callers
    building one step function per stage should skip stages whose snapped
    span is empty."""
    if window <= 1:
        return list(stages)
    out: List[SparsityStage] = []
    prev = 0
    for s in stages:
        first = int(round(s.first_step / window)) * window
        first = max(first, prev)
        out.append(dataclasses.replace(s, first_step=first))
        prev = first
    return out


def window_schedule(start: int, num_steps: int, window: int,
                    stages: List[SparsityStage]
                    ) -> Iterator[Tuple[int, int, SparsityStage]]:
    """Yield ``(step, length, stage)`` windows covering
    ``[start, num_steps)``: each window is at most ``window`` steps,
    ends on the window grid (so an off-grid ``start`` — e.g. a restore
    from a pre-windowing checkpoint — realigns after one short window),
    and never crosses a stage's ``first_step``. With stages already
    snapped via ``snap_stages_to_window`` the stage clamp is a no-op and
    every non-tail window is full-length."""
    firsts = stage_first_steps(stages)
    step = start
    while step < num_steps:
        end = min(step - step % window + window, num_steps)
        i = bisect.bisect_right(firsts, step)
        if i < len(firsts):  # next stage boundary caps the window
            end = min(end, firsts[i])
        yield step, end - step, stages[max(i - 1, 0)]
        step = end

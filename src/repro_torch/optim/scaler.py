"""Dynamic loss scaling: the grow/backoff state machine of the numeric
guard rail, in PyTorch.

The loss is multiplied by ``scale`` before the backward pass, so small
gradients survive the bf16 wire; a tripped step (``core.guard``) halves
the scale, ``growth_interval`` clean steps in a row double it. The state
is three 0-dim device tensors and ``update`` is ``torch.where`` over them,
so the verdict never goes to the host, and every scale it can produce is
a power of two times ``init_scale`` (exact, machine-independent traces).

A tripped step leaves parameters, optimizer state and CSC's ``hg`` and
``chunk_norms`` bit-identical; only this state advances.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import GuardConfig


class ScalerState(NamedTuple):
    """0-dim tensors on the step's device; the only state a rejected step
    may change."""

    scale: torch.Tensor         # f32 current loss scale
    growth_count: torch.Tensor  # i32 consecutive clean steps since a change
    skipped: torch.Tensor       # i32 total guard-rejected steps


def init(cfg: GuardConfig, device=None) -> ScalerState:
    return ScalerState(
        scale=torch.tensor(cfg.init_scale, dtype=torch.float32,
                           device=device),
        growth_count=torch.zeros((), dtype=torch.int32, device=device),
        skipped=torch.zeros((), dtype=torch.int32, device=device))


def update(state: ScalerState, ok: torch.Tensor,
           cfg: GuardConfig) -> ScalerState:
    """One transition on the step's verdict ``ok`` (a bool device tensor):

    ok  -> growth_count += 1; at ``growth_interval`` the scale grows by
           ``growth_factor`` (clamped to ``max_scale``) and the count resets;
    not -> the scale backs off by ``backoff_factor`` (clamped to
           ``min_scale``), the count resets, ``skipped`` += 1.

    Returns a new state; the old one is left as it was."""
    ok = ok.to(torch.bool)
    count = state.growth_count + 1
    grew = count >= cfg.growth_interval
    scale_ok = torch.where(
        grew, torch.clamp_max(state.scale * cfg.growth_factor,
                              cfg.max_scale), state.scale)
    count_ok = torch.where(grew, 0, count)
    scale_bad = torch.clamp_min(state.scale * cfg.backoff_factor,
                                cfg.min_scale)
    return ScalerState(
        scale=torch.where(ok, scale_ok, scale_bad),
        growth_count=torch.where(ok, count_ok, 0),
        skipped=state.skipped + (~ok).to(torch.int32))

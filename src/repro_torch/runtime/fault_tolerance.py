"""Fault-tolerant training supervision: checkpoint/restart.

``TrainSupervisor`` wraps a step (or window) function with:
  * periodic async checkpoints (``checkpoint.CheckpointManager``),
  * restart-on-failure: any exception (or injected fault, for tests) rolls
    back to the latest complete checkpoint, skips the data pipeline ahead,
    and resumes — bounded by ``max_restarts``, with a seeded backoff,
  * preemption handling: a callback (SIGTERM on real clusters; a flag in
    tests) triggers a final blocking checkpoint before exit.

A run's last step is saved once, by the blocking save after the loop,
and a preemption at a step the cadence just saved waits for that save
(the JAX package writes the same step again in both cases).

The port's train state is updated **in place** (a step writes into the
same parameter and optimizer tensors, and a CUDA-graph window refuses any
other tensors), so a restore copies into the live tensors
(``CheckpointManager.restore``). For the same reason the start state is
not a snapshot by itself, as in the JAX package, where arrays are
immutable: the supervisor copies it to host memory when ``run`` starts
and, on a fault before any checkpoint exists, copies that back into the
live tensors. On a multi-rank run every rank runs the same loop, so the
checkpoint collectives line up; under a model axis each rank's host copy
is of its own blocks, and the manager (built with the trainer's
``checkpoint_layout``) saves and restores the global arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointCorrupt,
                                            CheckpointManager,
                                            assert_flushed_state, flatten,
                                            is_scratch, rebuild)


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_every: int = 50
    max_restarts: int = 3
    keep: int = 3
    # Exponential backoff between restarts: the n-th restart sleeps
    # min(base * factor^(n-1), max) * (1 +/- jitter), with the jitter
    # drawn from a seeded integer stream (deterministic, injectable
    # clock). base 0.0 disables the sleep (the default keeps tests
    # instant); real clusters want seconds here so a crash loop doesn't
    # hammer the checkpoint store.
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    backoff_jitter: float = 0.1
    seed: int = 0


class Preempted(Exception):
    pass


def round_checkpoint_every(every: int, window: int) -> int:
    """Checkpoint cadence rounded to the window grid: the nearest
    positive multiple of ``window`` (at least one window). Windows end on
    the grid, so a grid-multiple cadence means every checkpoint lands
    exactly on a window edge — the supervisor never has to split a
    window to save."""
    if window <= 1:
        return every
    return max(window, int(round(every / window)) * window)


class _StartState:
    """A host copy of a state's leaves (scratch leaves aside), taken when
    a run starts, that can be written back into the live tensors (the
    restart before the first checkpoint)."""

    def __init__(self, state: Any):
        self._leaves = [x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor) and not is_scratch(n)
                        else x for n, x in flatten(state)]

    def restore_into(self, state: Any) -> Any:
        out = []
        for (n, w), x in zip(flatten(state), self._leaves):
            if isinstance(w, torch.Tensor) and not is_scratch(n):
                w.copy_(x)
                out.append(w)
            else:
                out.append(x)
        return rebuild(state, out)


class TrainSupervisor:
    def __init__(self, ckpt: CheckpointManager, cfg: SupervisorConfig,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.ckpt = ckpt
        self.cfg = cfg
        self.restarts = 0
        self.restart_causes: List[str] = []   # one entry per restart
        self.backoffs: List[float] = []       # seconds slept per restart
        self._preempt = False
        self._sleep = sleep_fn
        self._rng = np.random.default_rng(cfg.seed)

    def run_stats(self) -> Dict[str, Any]:
        """Restart accounting for run reports."""
        return {"restarts": self.restarts,
                "restart_causes": list(self.restart_causes),
                "backoffs_s": list(self.backoffs)}

    def _backoff(self) -> None:
        """Sleep before the n-th restart (n = self.restarts, already
        incremented). Jitter comes from integer draws so the delay
        sequence is deterministic for a given seed; the injectable
        ``sleep_fn`` keeps tests instant."""
        cfg = self.cfg
        if cfg.backoff_base_s <= 0:
            self.backoffs.append(0.0)
            return
        delay = min(cfg.backoff_base_s *
                    cfg.backoff_factor ** (self.restarts - 1),
                    cfg.backoff_max_s)
        j = int(self._rng.integers(0, 1001)) / 1000.0
        delay *= 1.0 + cfg.backoff_jitter * (2.0 * j - 1.0)
        self.backoffs.append(delay)
        self._sleep(delay)

    def request_preemption(self):
        """Hook for SIGTERM / maintenance-event handlers."""
        self._preempt = True

    def clear_preemption(self):
        """Acknowledge a handled preemption (notice consumed, the host
        evicted/replaced) so a subsequent ``run`` doesn't immediately
        re-raise."""
        self._preempt = False

    def _recover(self, e: Exception, state: Any, start_step: int,
                 start: _StartState, on_restore):
        """Count the restart (re-raising past the budget), back off, and
        restore the newest valid checkpoint into the live state — or,
        with none on disk, the start state. Returns (step, state)."""
        self.restarts += 1
        self.restart_causes.append(f"{type(e).__name__}: {e}")
        if self.restarts > self.cfg.max_restarts:
            raise e
        self._backoff()
        self.ckpt.wait()
        try:
            # Newest VALID checkpoint: restore() verifies the manifest
            # checksums and walks back past corrupt snapshots on its own.
            step, state = self.ckpt.restore(state)
        except (FileNotFoundError, CheckpointCorrupt):
            # no (intact) checkpoint yet: restart from the start state
            step, state = start_step, start.restore_into(state)
        if on_restore is not None:
            on_restore(step)
        return step, state

    def _save_preempted(self, step: int, saved: Optional[int],
                        state: Any) -> None:
        """The blocking checkpoint of a preemption at ``step``; a step the
        cadence just saved is only waited for, not written again."""
        if saved == step:
            self.ckpt.wait()
        else:
            self.ckpt.save(step, state, blocking=True)

    def run(
        self,
        state: Any,
        start_step: int,
        num_steps: int,
        step_fn: Callable[[int, Any], Any],     # (step, state) -> state
        on_restore: Optional[Callable[[int], None]] = None,  # e.g. data skip
        fault_injector: Optional[Callable[[int], None]] = None,
    ) -> Any:
        """Drive the loop with checkpoint/restart semantics. Returns the
        final state. ``fault_injector`` raising at a step simulates a node
        failure (tests use this to exercise the restart path)."""
        step, saved = start_step, None
        start = _StartState(state)
        while step < num_steps:
            try:
                if self._preempt:
                    raise Preempted()
                if fault_injector is not None:
                    fault_injector(step)
                state = step_fn(step, state)
                step += 1
                # The last step's save is the blocking one after the loop.
                if step % self.cfg.checkpoint_every == 0 \
                        and step < num_steps:
                    self.ckpt.save(step, state)
                    saved = step
            except Preempted:
                self._save_preempted(step, saved, state)
                raise
            except Exception as e:
                step, state = self._recover(e, state, start_step, start,
                                            on_restore)
        self.ckpt.save(step, state, blocking=True)
        return state

    def run_windows(
        self,
        state: Any,
        start_step: int,
        num_steps: int,
        window_fn: Callable[[int, int, Any], Any],  # (step, len, state)
        window: int,
        on_restore: Optional[Callable[[int], None]] = None,
        fault_injector: Optional[Callable[[int], None]] = None,
    ) -> Any:
        """``run`` for windows: ``window_fn(step, length, state)`` advances
        ``length`` steps as one unit (on the card one CUDA graph), so the
        host only regains control (and can checkpoint) on window edges.
        ``checkpoint_every`` is rounded to a multiple of ``window``
        (``round_checkpoint_every``); a save fires when a window's end
        crosses a cadence multiple — with grid-aligned windows that IS
        the multiple. ``fault_injector`` is probed for every step a window
        covers before it launches (a host-visible fault anywhere in a
        window kills the whole window; data-plane faults inside the window
        are ``runtime.faults``' device hooks instead). Restarts restore
        the newest valid checkpoint — always a window edge — into the
        live state and resume on the grid."""
        every = round_checkpoint_every(self.cfg.checkpoint_every, window)
        step, saved = start_step, None
        start = _StartState(state)
        while step < num_steps:
            length = min(window - step % window, num_steps - step)
            try:
                if self._preempt:
                    raise Preempted()
                if fault_injector is not None:
                    for s in range(step, step + length):
                        fault_injector(s)
                state = window_fn(step, length, state)
                # Window edges flush the cross-step pipeline lane; a
                # state escaping a window with one still in flight is a
                # harness bug — fail fast, not just at checkpoint time.
                assert_flushed_state(state, what="run_windows")
                prev, step = step, step + length
                if step // every > prev // every and step < num_steps:
                    self.ckpt.save(step, state)
                    saved = step
            except Preempted:
                self._save_preempted(step, saved, state)
                raise
            except Exception as e:
                step, state = self._recover(e, state, start_step, start,
                                            on_restore)
        self.ckpt.save(step, state, blocking=True)
        return state

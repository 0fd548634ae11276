"""Straggler detection + mitigation policy (pure Python; the same policy
as the JAX package's ``repro/runtime/stragglers.py``).

In synchronous data-parallel training every step runs at the pace of the
slowest rank, so mitigation is a *control-plane* decision. The detector keeps a per-host
EWMA of step wall-times and flags hosts whose latency exceeds
``threshold`` x the cluster median for ``patience`` consecutive windows.

Policies (returned as recommendations; the supervisor acts):
  'remesh'      — checkpoint, drop the slow host(s), relaunch at the
                  smaller world size (pairs with
                  ``checkpoint.reshard``).
  'rebatch'     — shrink the global batch by the slow shard's share and
                  rescale LR by the linear-scaling rule (paper §4.2).
  'none'        — within tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass
class StragglerReport:
    slow_hosts: List[int]
    action: str                 # 'none' | 'rebatch' | 'remesh'
    lr_rescale: float = 1.0     # for 'rebatch'


class StragglerDetector:
    def __init__(self, num_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3,
                 remesh_after: int = 10):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.remesh_after = remesh_after
        self.ewma: List[Optional[float]] = [None] * num_hosts
        self.flags: List[int] = [0] * num_hosts

    def reset(self, num_hosts: Optional[int] = None) -> None:
        """Re-initialize after a membership change (remesh / host join).

        Host indices are positions in the supervisor's current host list,
        so after an elastic event old EWMAs describe the wrong hosts —
        carrying them over would let a stale flag evict an innocent host,
        and a grown list would hit the ``observe`` length assert. Every
        host restarts cold: its next observation seeds the EWMA directly
        (the cold-start path), flags at zero."""
        if num_hosts is not None:
            assert num_hosts >= 1, num_hosts
            self.num_hosts = int(num_hosts)
        self.ewma = [None] * self.num_hosts
        self.flags = [0] * self.num_hosts

    def observe(self, step_times: Sequence[float]) -> StragglerReport:
        assert len(step_times) == self.num_hosts
        for i, t in enumerate(step_times):
            prev = self.ewma[i]
            self.ewma[i] = t if prev is None else \
                (1 - self.alpha) * prev + self.alpha * t
        vals = sorted(v for v in self.ewma if v is not None)
        median = vals[len(vals) // 2]
        slow = []
        for i, v in enumerate(self.ewma):
            if v is not None and v > self.threshold * median:
                self.flags[i] += 1
                if self.flags[i] >= self.patience:
                    slow.append(i)
            else:
                self.flags[i] = 0
        if not slow:
            return StragglerReport(slow_hosts=[], action="none")
        persistent = [i for i in slow if self.flags[i] >= self.remesh_after]
        if persistent:
            return StragglerReport(slow_hosts=persistent, action="remesh")
        frac = 1.0 - len(slow) / self.num_hosts
        return StragglerReport(slow_hosts=slow, action="rebatch",
                               lr_rescale=frac)

"""What the program measured of itself (``repro_torch.runtime.trace``):
its counters, and the records of its training calls. A program without
that module has neither, and every reader of them finds nothing."""
from __future__ import annotations

from typing import Dict, List, Optional


def _trace():
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace


def counters() -> Optional[Dict[str, Dict[str, float]]]:
    """The program's counters by group, or None."""
    trace = _trace()
    return trace.counters if trace is not None else None


def profiled_calls() -> List[Dict]:
    """The records of the calls a profiler recorded (the traced
    stretch's), oldest first; empty without them."""
    trace = _trace()
    if trace is None:
        return []
    return [r for r in trace.records if r["profiled"]]


def per_step(group: str, name: str) -> Optional[float]:
    """A counter's change over the profiled calls, a step; None without
    profiled calls."""
    calls = profiled_calls()
    steps = sum(r["steps"] for r in calls)
    if not steps:
        return None
    return sum(r["counts"].get(group, {}).get(name, 0)
               for r in calls) / steps

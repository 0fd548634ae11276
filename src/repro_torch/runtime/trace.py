"""The port's own measurement: named spans on the profiler's clock, one
registry of counters, and a record of each training call.

**Spans.** ``span(name)`` enters ``torch.profiler.record_function(name)``
only while a torch profiler records (the module flag
``torch.autograd.profiler._is_profiler_enabled``), so a span is a
``user_annotation`` event in the same chrome trace as the kernels and
copies, on their clock; nesting gives the parent span. With no profiler
recording a span costs that flag check and an empty context. A span is
host-only: inside a CUDA graph capture it adds no node to the graph.
Names are fixed strings with a layer prefix:

* ``launch.call`` (one public training call: ``TrainWindow.__call__``,
  the step of ``Trainer.build_train_step``), ``launch.fill``,
  ``launch.replay``, ``launch.reduce_metrics``, and in a window's set-up
  ``launch.warmup`` and ``launch.capture``;
* ``model.forward`` and ``model.backward`` (each microbatch);
* ``moe.route``, ``moe.permute``, ``moe.experts``, ``moe.combine`` (the
  sigmoid-routed MoE layer's stages, each forward, remat's too);
* ``gf.pack``, ``gf.census``, ``gf.select``, ``gf.gather``, ``gf.issue``
  (one bucket's collective issued), ``gf.wait``, ``gf.scatter``,
  ``gf.update`` (one span's unpack-update), ``gf.apply_inflight``;
* ``comm.all_reduce`` (the entry of each collective, data group and
  model group).

**Counters.** ``counters`` maps a group to a dict from name to number,
always on (host integer adds):

* ``dispatch``: ``kernels.ops``'s decisions, ``"<kernel>.kernel"`` or
  ``"<kernel>.plain"`` (``ops.dispatch_counts`` is this dict);
* ``comm``: ``calls`` and ``bytes`` of the data group's collectives
  when it has more than one rank, once a collective, its payload in the
  dtype it travels in;
* ``model_axis``: ``all_reduces`` and ``bytes`` of the model group's;
* ``launch``: ``warmup_s`` and ``capture_s``, the host seconds of the
  ``launch.warmup`` and ``launch.capture`` spans (``timed``);
* ``moe``: ``rows``, the slots the held experts computed, a device
  tally (each sigmoid-routed MoE layer's backward adds its own once a
  step, remat or not).

Counters count host events: a CUDA graph's work is counted once, when it
is captured. A device tally (``tally``) is a counter kept on the device
and added to by the program's own kernels, so every replay of a graph
counts; it is read (a host sync) only at a profiled call's start and
end, and its change joins that call's record.

**Call records.** ``call(steps)`` opens ``launch.call`` and, for the
outermost call, leaves a record in ``records`` (the last
``RECORDS`` calls): the steps, the counters' change over the call and
whether a profiler was recording. A graph replay adds the counts its
capture took (``replayed``), since the replay runs exactly that work, so
a record counts what the device was given in the call. Nothing is
written out; a reader takes the records at the end of a run.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

Counts = Dict[str, Dict[str, float]]

counters: Counts = {
    "dispatch": {},
    "comm": {"calls": 0, "bytes": 0},
    "model_axis": {"all_reduces": 0, "bytes": 0},
    "launch": {"warmup_s": 0.0, "capture_s": 0.0},
}

# (group, name) -> {device: int64 0-dim tensor}
_tallies: Dict[Tuple[str, str], Dict[torch.device, torch.Tensor]] = {}

RECORDS = 64
records: Deque[Dict] = collections.deque(maxlen=RECORDS)
_open: List["call"] = []


def recording() -> bool:
    """Is a torch profiler recording?"""
    return _profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` a ``record_function`` range while a profiler
    records, else nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


class timed:
    """``with timed(name, group, key) as t:`` ``span(name)``, and its host
    seconds (one ``perf_counter`` pair, whether or not a profiler
    records) added to ``counters[group][key]`` and kept in
    ``t.seconds``."""

    def __init__(self, name: str, group: str, key: str):
        self.name, self.group, self.key = name, group, key
        self.seconds = 0.0

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        counters[self.group][self.key] += self.seconds
        return self._span.__exit__(*exc)


def tally(group: str, name: str, value: torch.Tensor) -> None:
    """Add the 0-dim integer tensor ``value`` to the device tally (group,
    name) on its device, in place: inside a CUDA graph capture the add is
    a node of the graph, so every replay counts. A tally is made at its
    first add, which must run outside a capture (a window's warm-up body
    runs first)."""
    per = _tallies.setdefault((group, name), {})
    t = per.get(value.device)
    if t is None:
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the device tally {group}.{name} is first "
                               f"added to inside a CUDA graph capture")
        t = per[value.device] = torch.zeros((), dtype=torch.int64,
                                            device=value.device)
    t.add_(value)


def tallies() -> Counts:
    """Every device tally, summed over its devices: a host read of each
    (it waits for the device)."""
    out: Counts = {}
    for (group, name), per in _tallies.items():
        out.setdefault(group, {})[name] = sum(int(t) for t in per.values())
    return out


def snapshot() -> Counts:
    """A copy of every group."""
    return {g: dict(c) for g, c in counters.items()}


def delta(after: Counts, before: Counts) -> Counts:
    """``after - before``, by group, the names that changed."""
    out: Counts = {}
    for g, c in after.items():
        was = before.get(g, {})
        d = {k: v - was.get(k, 0) for k, v in c.items() if v != was.get(k, 0)}
        if d:
            out[g] = d
    return out


def add(into: Counts, more: Counts) -> Counts:
    """``into += more``, by group and name, in place."""
    for g, c in more.items():
        mine = into.setdefault(g, {})
        for k, v in c.items():
            mine[k] = mine.get(k, 0) + v
    return into


class call:
    """``with call(steps):`` the ``launch.call`` span; the outermost call
    leaves its record in ``records`` when it ends without raising."""

    def __init__(self, steps: int):
        self.steps = steps
        self._before: Optional[Counts] = None

    def __enter__(self):
        if not _open:
            self._before = snapshot()
            self.extra: Counts = {}
            self.profiled = recording()
            if self.profiled:
                self._tallied = tallies()
        _open.append(self)
        self._span = span("launch.call")
        self._span.__enter__()
        return self

    def __exit__(self, kind, *rest):
        self._span.__exit__(kind, *rest)
        _open.pop()
        if self._before is not None and kind is None:
            counts = add(delta(snapshot(), self._before), self.extra)
            if self.profiled:
                add(counts, delta(tallies(), self._tallied))
            records.append({"steps": self.steps, "counts": counts,
                            "profiled": self.profiled})
        return False


def replayed(counts: Counts) -> None:
    """A graph replay inside the open call: its record takes the counts
    the graph's capture took."""
    if _open:
        add(_open[0].extra, counts)

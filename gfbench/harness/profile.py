"""The traced stretch: ``torch.profiler`` over a few steady steps,
reduced to the device's activity (kernels, copies, fills) and the
host's operations inside the stretch's span.

Kernels are classed by name: the port's six hand-written kernels, the
collectives (NCCL's and the port's ring), and the rest, which is the
model's forward and backward (cuBLAS, the elementwise and reduction
kernels of PyTorch's ops).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

SPAN = "gfbench.traced"
GPU_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
              "cuda_driver")
BACKEND_KERNELS = ("pool_pack", "pool_unpack", "chunk_l1norm", "csc_compact",
                   "fused_update")
RING_KERNEL = "ring_kernel"

Interval = Tuple[float, float]


def is_comm(name: str) -> bool:
    return "nccl" in name.lower() or RING_KERNEL in name


def is_backend(name: str) -> bool:
    return any(k in name for k in BACKEND_KERNELS)


def is_model(name: str) -> bool:
    return not (is_comm(name) or is_backend(name))


@dataclasses.dataclass
class Event:
    name: str
    start: float   # seconds
    end: float
    kind: str      # 'kernel', 'gpu_memcpy', 'gpu_memset' or a host kind


@dataclasses.dataclass
class Trace:
    """What the traced stretch left: its span on the host clock, the
    device's activity and the host's operations inside it, and the steps
    it ran."""
    span: Interval
    device: List[Event]
    host: List[Event]
    steps: int
    power_limit_w: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def kernels(self, keep=lambda name: True) -> List[Event]:
        return [e for e in self.device if e.kind == "kernel" and keep(e.name)]

    def busy_s(self) -> float:
        return measure(union([(e.start, e.end) for e in self.device]))


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def measure(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def minus(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The parts of the disjoint sorted intervals ``a`` that the disjoint
    sorted intervals ``b`` do not cover."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def kernel_seconds(trace: Trace, keep) -> float:
    """Summed device seconds of the kernels ``keep`` selects."""
    return sum(e.end - e.start for e in trace.kernels(keep))


@contextlib.contextmanager
def traced() -> Iterator[Dict]:
    """Profile the block (host and device activity) inside one span;
    ``box['events']`` holds the trace's events afterwards. The trace is
    written under the process's temporary directory, read back, and
    deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box: Dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        with record_function(SPAN):
            yield box
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["events"] = json.load(f)["traceEvents"]


def reduce(raw: List[Dict], steps: int) -> Trace:
    """The span, and the device and host events clipped to it, from a
    chrome trace's events (timestamps in microseconds)."""
    span = None
    device: List[Event] = []
    host: List[Event] = []
    for e in raw:
        if e.get("ph") != "X":
            continue
        kind, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"]) * 1e-6
        end = start + float(e.get("dur", 0.0)) * 1e-6
        if kind == "user_annotation" and name == SPAN:
            span = (start, end)
        elif kind in GPU_KINDS:
            device.append(Event(name, start, end, kind))
        elif kind in HOST_KINDS:
            host.append(Event(name, start, end, kind))
    if span is None:
        raise RuntimeError(f"the profile has no {SPAN!r} span")

    def clip(events):
        out = []
        for ev in events:
            s, t = max(ev.start, span[0]), min(ev.end, span[1])
            if t > s:
                out.append(dataclasses.replace(ev, start=s, end=t))
        return out

    device = clip(device)
    if not any(e.kind == "kernel" for e in device):
        raise RuntimeError("the profile shows no kernel inside the traced "
                           "span")
    return Trace(span=span, device=device, host=clip(host), steps=steps)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, by name, and the
    longest idle gaps of the device, each named by the innermost host
    operation running at the gap's middle."""
    by_name: Dict[str, float] = {}
    for e in trace.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(e.start, e.end) for e in trace.device])
    gaps = minus([trace.span], busy)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        inside = [h for h in trace.host if h.start <= mid <= h.end]
        what = min(inside, key=lambda h: h.end - h.start).name \
            if inside else "host idle"
        named.append([what, e - s])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": named}

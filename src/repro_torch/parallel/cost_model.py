"""Analytic collective cost model (alpha-beta with small-message effective
bandwidth), calibrated to the paper's clusters: the port's copy of the JAX
package's ``parallel/cost_model.py``, function for function (the CPU tests
hold every function equal to the JAX package's).

The topology layer (``repro_torch.parallel.topology``) prices collectives
with it to pick a reduce algorithm and a lazy-allreduce bucket size θ per
pool.

Primitives:

  t_ring(M, N)  = 2(N-1) * (alpha + (M/N) / bw_eff(M/N))     allreduce
  t_rs(M, N)    =  (N-1) * (alpha + (M/N) / bw_eff(M/N))     reduce-scatter
  t_ag(M, N)    =  (N-1) * (alpha + (M/N) / bw_eff(M/N))     all-gather
  bw_eff(s)     = BW_peak * s / (s + s_half)          [half-performance size]

A ring allreduce is exactly reduce-scatter + all-gather, which is why the
two-level/tree algorithms price their per-level phases with
``reduce_scatter_time`` / ``all_gather_time`` and their top-level sum with
``ring_allreduce_time``.

The fabric constants describe the paper's clusters (56 Gbps InfiniBand,
V100 nodes), not an H100: they rank algorithms, they predict no time of
this port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Fabric:
    """One interconnect's alpha-beta parameters.

    Hashable and frozen so it can ride inside ``GradientFlowConfig`` (via
    ``Topology``) as a jit static argument.
    """

    name: str
    bw_peak: float      # bytes/s achievable by the backend on this fabric
    alpha: float        # per-ring-step latency (s)
    s_half: float       # half-performance message size (bytes)


# 56 Gbps IB = 7 GB/s line rate. Backends reach different fractions of it
# (Fig 8: NCCL ~ near line rate at >=64MB; OpenMPI plateaus much lower).
# Calibration anchors (Cluster-V, N=512, paper Tables 1-2):
#   NCCL+MP AlexNet dense-26-msg comm ~ 170 ms  -> alpha = 5 us
#   NCCL+MP+LA 4-bucket comm ~ 60 ms            -> near-peak big-message bw
#   MPI AlexNet ~ 1.1 s / ResNet ~ 1.7 s        -> alpha = 15 us, 1.2 GB/s
NCCL_56G = Fabric("nccl-56G", bw_peak=6.5e9, alpha=5e-6, s_half=16e3)
MPI_56G = Fabric("mpi-56G", bw_peak=0.75e9, alpha=15e-6, s_half=256e3)
# Gloo (PyTorch default in §2.3) — the paper measured 3.3% utilization.
GLOO_56G = Fabric("gloo-56G", bw_peak=0.25e9, alpha=60e-6, s_half=1e6)
# Intra-node PCIe/NVLink-class link (Cluster-V packs 8 V100s per node).
# The paper's NCCL-H observation: intra-node phases are latency-cheap and
# bandwidth-rich relative to the 56G wire.
INTRA_NODE = Fabric("intra-node", bw_peak=10e9, alpha=1.5e-6, s_half=8e3)
# Placeholder-device fabric for simulated host meshes (tests / dryrun).
HOST_LOOPBACK = Fabric("host-loopback", bw_peak=20e9, alpha=1e-6,
                       s_half=4e3)


def bw_eff(fabric: Fabric, per_step_bytes: float) -> float:
    return fabric.bw_peak * per_step_bytes / (per_step_bytes
                                              + fabric.s_half)


def ring_allreduce_time(msg_bytes: float, n: int, fabric: Fabric) -> float:
    """One ring allreduce of msg_bytes over n ranks."""
    if msg_bytes <= 0 or n <= 1:
        return 0.0
    per_step = msg_bytes / n
    steps = 2 * (n - 1)
    return steps * (fabric.alpha + per_step / bw_eff(fabric, per_step))


def ring_exchange_steps(n: int) -> int:
    """Neighbor exchanges in one ring allreduce: (n-1) reduce-scatter +
    (n-1) all-gather steps. The owned ring implementation
    (``repro_torch.kernels.ring_reduce`` / the plain twin) executes exactly
    this many — tests and the CI ring gate pin the count."""
    return 2 * (n - 1) if n > 1 else 0


def ring_step_wire_bytes(msg_bytes: float, n: int) -> float:
    """Bytes each rank puts on the wire per exchange step: one
    ceil(msg/n) segment (the padded segment of a ragged message). The
    exact element-level number lives in ``repro_torch.kernels.ring_reduce.plan``
    — this is the model-level mirror the selector prices with."""
    if n <= 1:
        return 0.0
    return float(math.ceil(msg_bytes / n))


def sequential_ring_time(msg_bytes: float,
                         levels: Sequence[Tuple[int, Fabric]]) -> float:
    """Predicted time of the ``pallas_ring`` execution model: one
    full-payload ring per (size, fabric) level, innermost first. On a
    single level this is *identical* to the flat ring — same schedule,
    same wire bytes — so the auto-selector's strict-improvement rule
    keeps the psum-backed flat entry on ties and ``pallas_ring`` remains
    an explicit opt-in. On hierarchical fabrics each level pays for the
    whole payload, which two_level/tree undercut by design."""
    return sum(ring_allreduce_time(msg_bytes, n, f) for n, f in levels)


def reduce_scatter_time(msg_bytes: float, n: int, fabric: Fabric) -> float:
    """Ring reduce-scatter: each rank ends with a summed msg/n shard."""
    if msg_bytes <= 0 or n <= 1:
        return 0.0
    per_step = msg_bytes / n
    return (n - 1) * (fabric.alpha + per_step / bw_eff(fabric, per_step))


def all_gather_time(msg_bytes: float, n: int, fabric: Fabric) -> float:
    """Ring all-gather of a msg/n shard back to the full msg."""
    return reduce_scatter_time(msg_bytes, n, fabric)


def hierarchical_allreduce_time(msg_bytes: float, n: int, group: int,
                                fabric: Fabric,
                                intra_bw: float = 10e9) -> float:
    """NCCL-H (Fig 7b): intra-group reduce + inter-group ring + broadcast.
    Intra-group ops are NOT bandwidth optimal (the paper's observation).

    Kept for the Figure-7 benchmark comparison; the library's two-level
    algorithm (reduce-scatter based, bandwidth-optimal intra phase) is
    priced by ``topology.TwoLevel.predicted_time``.
    """
    m = n // group
    t_intra = 2 * (msg_bytes / intra_bw + fabric.alpha * group)
    per_step = msg_bytes / m
    t_inter = 2 * (m - 1) * (fabric.alpha
                             + per_step / bw_eff(fabric, per_step))
    return t_intra + t_inter


def allreduce_sequence_time(messages: Sequence[float], n: int,
                            fabric: Fabric) -> float:
    """Total wire time of a sequence of allreduces (no overlap)."""
    return sum(ring_allreduce_time(m, n, fabric) for m in messages)


def effective_throughput(msg_bytes: float, n: int, fabric: Fabric) -> float:
    """Algorithm bandwidth (bytes/s): payload / time (the Fig 8 y-axis)."""
    t = ring_allreduce_time(msg_bytes, n, fabric)
    return msg_bytes / t if t else float("inf")


# -- overlap / bucket-size model ---------------------------------------------


def overlapped_finish_time(bucket_times: Sequence[float],
                           release_times: Sequence[float]) -> float:
    """Finish time of the last collective when bucket i may start only
    after ``release_times[i]`` (the backward compute that produces it) and
    the comm engine is serial (one in-flight collective, §3.1's model).

    Returns the absolute finish time; exposed comm for the iteration is
    ``finish - total_backward`` clamped at 0.
    """
    t = 0.0
    for bt, rel in zip(bucket_times, release_times):
        t = max(t, rel) + bt
    return t


def bucket_release_times(bucket_bytes: Sequence[float],
                         backward_s: float) -> List[float]:
    """Model backward as producing pool bytes at a uniform rate: bucket i
    is ready once the cumulative bytes up to and including it are done."""
    total = sum(bucket_bytes) or 1.0
    rel, acc = [], 0.0
    for b in bucket_bytes:
        acc += b
        rel.append(backward_s * acc / total)
    return rel


# -- staged (reduce_i ∥ update_{i-1}) pipeline timeline ----------------------
#
# The overlap engine (repro_torch.core.engine) executes the train step as a
# per-bucket software pipeline: bucket i's collective is issued while
# bucket i-1's fused optimizer update runs. These functions are its
# analytic mirror — the same two-engine model (one serial comm engine, one
# serial update engine) the θ auto-tuner and the dryrun timeline use.

# HBM bandwidth of the update engine (V100-class HBM2, the paper's
# Cluster-V part) and the bytes the fused update moves per pool element:
# read master+grads+momentum f32 + the mask byte, write master+momentum.
HBM_BW = 900e9
UPDATE_BYTES_PER_ELEM = 5 * 4 + 1


def update_time(elems: float, hbm_bw: float = HBM_BW) -> float:
    """Modeled wall time of the fused optimizer update on ``elems`` pool
    elements: one read+write sweep of the pool-sized operands at HBM
    bandwidth (the kernel is memory-bound by construction)."""
    return elems * UPDATE_BYTES_PER_ELEM / hbm_bw


@dataclasses.dataclass(frozen=True)
class BucketTimeline:
    """One bucket's simulated schedule inside the staged pipeline."""

    index: int
    release_s: float       # backward finishes producing this bucket
    comm_start_s: float    # collective issued (serial comm engine)
    comm_end_s: float
    update_start_s: float  # fused update starts (serial update engine)
    update_end_s: float

    def exposed_comm_s(self, backward_s: float) -> float:
        """The part of this bucket's collective that runs after backward
        has fully finished — wire time nothing can hide anymore."""
        return max(0.0, self.comm_end_s - max(backward_s,
                                              self.comm_start_s))



def staged_timeline(bucket_comm_s: Sequence[float],
                    release_s: Sequence[float],
                    bucket_update_s: Sequence[float],
                    ) -> List[BucketTimeline]:
    """Simulate the staged pipeline: a serial comm engine (one in-flight
    collective, §3.1's model) chained into a serial update engine — bucket
    i's update may start once its collective lands AND update i-1 retired.
    Returns one row per bucket; the last row's ``update_end_s`` is the
    step's finish time."""
    rows: List[BucketTimeline] = []
    comm_t = upd_t = 0.0
    for i, (ct, rel, ut) in enumerate(zip(bucket_comm_s, release_s,
                                          bucket_update_s)):
        start = max(comm_t, rel)
        comm_t = start + ct
        u_start = max(comm_t, upd_t)
        upd_t = u_start + ut
        rows.append(BucketTimeline(index=i, release_s=rel,
                                   comm_start_s=start, comm_end_s=comm_t,
                                   update_start_s=u_start,
                                   update_end_s=upd_t))
    return rows


def timeline_summary(rows: Sequence[BucketTimeline],
                     backward_s: float) -> dict:
    """Aggregate overlap metrics of a staged timeline.

    ``exposed_comm_s`` is the comm time the step actually waits for —
    finish of the last collective minus the backward it hid behind,
    clamped at 0 (the same definition ``overlapped_finish_time`` documents)
    — and ``overlap_efficiency`` the fraction of total wire time hidden
    under backward compute."""
    if not rows:
        return {"finish_s": backward_s, "comm_busy_s": 0.0,
                "update_busy_s": 0.0, "exposed_comm_s": 0.0,
                "overlap_efficiency": 1.0}
    comm_busy = sum(r.comm_end_s - r.comm_start_s for r in rows)
    upd_busy = sum(r.update_end_s - r.update_start_s for r in rows)
    comm_finish = rows[-1].comm_end_s
    exposed = max(0.0, comm_finish - backward_s)
    return {
        "finish_s": rows[-1].update_end_s,
        "comm_busy_s": comm_busy,
        "update_busy_s": upd_busy,
        "exposed_comm_s": exposed,
        "overlap_efficiency": (1.0 - exposed / comm_busy) if comm_busy
        else 1.0,
    }


def staged_finish_time(bucket_comm_s: Sequence[float],
                       release_s: Sequence[float],
                       bucket_update_s: Sequence[float]) -> float:
    """Finish time of the staged pipeline (last bucket's update retires).
    With all-zero update times this degenerates to
    ``overlapped_finish_time`` — the comm-only model the θ tuner used
    before the update engine existed."""
    rows = staged_timeline(bucket_comm_s, release_s, bucket_update_s)
    return rows[-1].update_end_s if rows else 0.0


# -- cross-step (two-row) pipeline timeline ----------------------------------
#
# The staged timeline above barriers at the step edge: every bucket's comm
# AND update must retire before the next step's compute starts, so the
# tail buckets' wire time past the backward is fully exposed. Cross-step
# pipelining (engine.run_pipelined + the scanned-window carry) exempts a
# trailing tail set from that barrier — their reduced segments ride the
# scan carry and their updates run at the START of the next step, before
# the forward pass first touches those params. The model here prices that
# two-row schedule: a serial compute row (fwd/bwd, length ``backward_s``
# per step, producing releases back-to-front and consuming params
# front-to-back in the mirrored order) against the shared serial comm and
# update engines, iterated to steady state.


def fwd_need_times(bucket_bytes: Sequence[float],
                   backward_s: float) -> List[float]:
    """Offset into a step's compute at which each bucket's params are
    FIRST consumed. The pool is laid out in reverse generation order
    (top layers at offset 0), so the forward pass consumes buckets from
    the pool END backwards: the last bucket is needed immediately
    (need 0), bucket i once the bytes after it have been traversed —
    the mirror of ``bucket_release_times``."""
    total = sum(bucket_bytes) or 1.0
    need, acc = [], 0.0
    for b in bucket_bytes:
        need.append(backward_s * (total - acc - b) / total)
        acc += b
    return need


def cross_step_timeline(bucket_comm_s: Sequence[float],
                        release_s: Sequence[float],
                        bucket_update_s: Sequence[float],
                        tail: int, backward_s: float, *,
                        need_s: Sequence[float] = None,
                        steps: int = 8) -> dict:
    """Simulate the cross-step pipeline to steady state.

    ``tail`` trailing buckets defer their update into the next step: the
    update (now an "apply") runs as the next step's prologue and only has
    to land before that step's compute first touches the bucket's params
    (``need_s``); head buckets keep the within-step barrier. The comm and
    update engines are serial and shared across steps (one in-flight
    collective, one in-flight update sweep — the §3.1 model, extended
    across the scan-body boundary).

    Returns the steady-state per-step period, the per-step exposed comm
    (sum over buckets of comm time past each bucket's deadline — the
    own-step backward end for head buckets, the next step's need time
    minus the apply sweep for tail buckets), and the last simulated
    step's schedule rows as (index, deferred, comm_start, comm_end,
    retire_s) tuples relative to that step's compute start."""
    n = len(bucket_comm_s)
    assert 0 <= tail < max(n, 1), (tail, n)
    if n == 0:
        return {"period_s": backward_s, "exposed_comm_s": 0.0,
                "prologue_s": 0.0, "rows": [], "tail": 0}
    if need_s is None:
        # Uniform-rate mirror of the release schedule.
        need_s = [max(0.0, backward_s - r) for r in release_s]
    head = n - tail
    comm_free = upd_free = 0.0
    start = 0.0
    exposed = 0.0
    rows = []
    periods = []
    inflight = []  # (index, comm_start, comm_end) of the carried tail
    prev_start = None
    for _ in range(max(int(steps), 2)):
        rows = []
        exposed = 0.0
        # Apply the PREVIOUS step's in-flight tail (deferred updates):
        # fwd-consumption order (pool end first), each gated on its own
        # collective having landed.
        applied = []
        for i, cs, ce in reversed(inflight):
            u0 = max(upd_free, ce)
            upd_free = u0 + bucket_update_s[i]
            applied.append((i, cs, ce, upd_free))
        # This step's compute starts once the compute row is free AND
        # every carried apply beats its bucket's first consumption.
        nxt = max([start] + [ready - need_s[i]
                             for i, _, _, ready in applied])
        if prev_start is not None:
            periods.append(nxt - prev_start)
        prev_start = nxt
        for i, cs, ce, ready in applied:
            rows.append((i, True, cs, ce, ready))
            # Deadline: the comm had to land early enough for the apply
            # sweep to finish by the time fwd first reads the bucket.
            exposed += max(0.0, ce - max(cs, nxt + need_s[i]
                                         - bucket_update_s[i]))
        start = nxt
        bwd_end = start + backward_s
        # This step's collectives; head updates keep the step barrier,
        # tail reduces retire into the carry.
        inflight = []
        barrier = bwd_end
        for i in range(n):
            c0 = max(comm_free, start + release_s[i])
            comm_free = c0 + bucket_comm_s[i]
            if i < head:
                u0 = max(upd_free, comm_free)
                upd_free = u0 + bucket_update_s[i]
                barrier = max(barrier, upd_free)
                exposed += max(0.0, comm_free - max(c0, bwd_end))
                rows.append((i, False, c0, comm_free, upd_free))
            else:
                inflight.append((i, c0, comm_free))
        start = barrier
    # Steady state: the last iteration's period (converges within a
    # couple of steps — the serial engines drain any startup skew).
    period = periods[-1] if periods else backward_s
    return {"period_s": period,
            "exposed_comm_s": exposed,
            "prologue_s": sum(bucket_update_s[head:]),
            "rows": sorted(rows), "tail": tail}


def pipelined_finish_time(bucket_comm_s: Sequence[float],
                          release_s: Sequence[float],
                          bucket_update_s: Sequence[float],
                          tail: int, backward_s: float) -> float:
    """Steady-state per-step period of the cross-step pipeline — the
    number a tail set must shrink below ``staged_finish_time`` to pay
    for itself. ``tail=0`` reproduces the staged barrier exactly."""
    sim = cross_step_timeline(bucket_comm_s, release_s, bucket_update_s,
                              tail, backward_s)
    return sim["period_s"]


def select_pipeline_tail(bucket_comm_s: Sequence[float],
                         release_s: Sequence[float],
                         bucket_update_s: Sequence[float],
                         backward_s: float) -> int:
    """Auto-choose the deferred tail set (``pipeline_tail_buckets=-1``):
    the tail size minimizing modeled steady-state period PLUS deadline
    exposure (both seconds — the period is the hard wall-clock term, the
    exposure the latency-slack a real interleaving scheduler can still
    convert), ties going to the SMALLEST tail (deferring a bucket whose
    comm already hides buys nothing and costs carry state). At most
    ``n - 1`` buckets may defer — the first bucket always commits
    in-step, so a window edge is never more than one step from fully
    applied."""
    n = len(bucket_comm_s)
    if n <= 1:
        return 0
    best_tail, best_t = 0, None
    for tail in range(n):
        sim = cross_step_timeline(bucket_comm_s, release_s,
                                  bucket_update_s, tail, backward_s)
        t = sim["period_s"] + sim["exposed_comm_s"]
        if best_t is None or t < best_t - 1e-12:
            best_tail, best_t = tail, t
    return best_tail

"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the time to build the CUDA kernels from the sources
   under src/repro_torch/kernels/csrc (one nvcc process per source, all
   started together).
2. Kernels: each kernel of the training paths against its plain PyTorch
   version on the card, at the paths' shapes (the smollm-135m gradient
   pool: 134,515,008 elements in 11 leaves; padded to 134,545,408 =
   4106 chunks of 32,768 for CSC), timed with CUDA events (median of 20
   runs after 3 warm-up runs), beside the bytes bound and, where one
   PyTorch call computes the same function, that call's time (timed only;
   the port never calls it).
   - pool_pack: the lazy packs (grads f32->bf16, params f32->f32) and the
     CSC packs (both f32->f32 into the padded pool), bit for bit, pool
     and staging buffer; the chunk census to 1e-6 relative.
   - pool_unpack_update: lazy's 6 spans with an all-true and a random
     mask and with per-tensor ratios, CSC's 7 spans of the padded pool
     with a chunk-granular mask (the last span holds no leaf), and the
     whole padded pool in one launch with f32[T+1] ratios (LARS
     monolithic), bit for bit.
   - chunk_l1norm: the census of an f32 pool of 4106 x 32,768 (and of its
     bf16 cast) to 1e-6 relative against the plain version and
     torch.linalg.vector_norm, the same bits on two launches and, f32, at
     a grid of 77 CTAs.
   - csc_compact: the gather of k = 616 and k = 3233 sorted chunk ids,
     bit for bit against the plain version and torch.index_select, also
     at a grid of 77 CTAs.
   These two short kernels also print back_to_back_ms and
   library_back_to_back_ms (B2B launches in one event region, divided by
   B2B: the device's time once the host runs ahead), enqueue_ms and
   library_enqueue_ms (the host's time to enqueue one launch), and the
   launch plan; ms and library_ms stay one launch an event region, host
   time included, as in earlier runs.
   - ring_allreduce: N = 2, 4, 8 ranks in this process, each on its own
     stream (the in-process workspace), on the 6 lazy buckets, the whole
     lazy pool and the CSC steady wire buffer (616 x 32,768) in bf16, and
     the first bucket in f32, int8 and fp8-e4m3 (sums past 448); bit for
     bit against the plain ring with the kernel's segment, every rank the
     same bits, the first bucket also in place (out = x);
     library_ms is torch.stack(xs).float().sum(0); enqueue_ms the host
     time to enqueue the N launches; the 6 lazy buckets at N = 2 are also
     timed back to back in one region.
   - fused_update: the whole f32 pool, all-true and random mask, with and
     without the scale, bit for bit; then optim.update_pool, the entry
     point that reaches it, for 3 steps with its launches counted.
   - pool_unpack_update also with the guard's ``ok`` over the whole
     padded pool: ok = true equal to the launch without it, ok = false
     (NaN gradients) writing nothing; both timed.
   - Non-finite words (the ``nan_words`` line): NaN, +-Inf and 2^120 in
     the gradient leaves through the lazy bf16 pack, the CSC f32 pack and
     the census, and through the ring at N = 2 on the first lazy bucket
     with a NaN on one rank, each against its plain version with NaN
     compared by class; the NaN word each one emits.
   Then the optimizer ops, which are PyTorch ops and no kernel (as in
   the JAX package): one step's LARS trust ratios over the lazy spans and
   over CSC's masked spans (equal to the whole-pool ratios), and one AdamW
   update sweep over CSC's 7 spans, each timed beside its bytes bound.
   Then the ring on the low-bit wires' words (the ``quantized_ring``
   line): N = 2, 4, 8 ranks, each quantizing a θ bucket of its own
   gradients with the scales of the summed census; int8 equal to the flat
   integer sum bit for bit, fp8-e4m3 within the JAX package's gate (448 x
   the largest scale x 2^-4) of the f32 sum of the same words, with no
   NaN code (0x7F, 0xFF) in any word.
3. Train: smollm-135m at full width and depth (batch 16, sequence 1024,
   bf16 wire, kernels on) inside a world-size-1 NCCL group, through the
   CLI's loop (``repro_torch.launch.train``) on the synthetic stream,
   then through the Trainer it builds on one repeated batch:
   (a) lazy, momentum SGD, theta = 4 Mi elements: 6 + 6 steps;
   (b) CSC, momentum SGD, chunks of 32,768, sparsity 0.85 reached after
       4 warm-up steps: step 0 dense (7 buckets), steps 1-3 at k = 3233,
       2361, 1488, steps 4-7 at k = 616 (5 wire buckets); 8 + 8 steps;
   (d) LARS (lr LARS_LR), (b)'s CSC settings, staged: 8 + 8 steps, every
       update launch carrying the span's ratios;
   (e) LARS, lazy, staged (the CLI) and then monolithic (a Trainer with
       overlap='monolithic': one whole-pool update launch a step), 6 + 6
       steps each from one seed; the repeated batch's losses of the two
       modes equal to 1e-6 relative, the largest parameter difference
       printed;
   (f) AdamW (lr ADAMW_LR), (b)'s CSC settings, staged: 8 + 8 steps, no
       update kernel (AdamW is PyTorch ops);
   (c) collective_algo="pallas_ring", world size 2 as two processes on
       this card (this script with --ring-rank), a gloo group for the
       set-up and the cross-process (CUDA IPC) ring workspace, one per
       level group, shared by every bucket: lazy, 3 steps on the stream,
       then 3 on one repeated batch, the first step's post-reduce pool
       equal to the plain ring of the two ranks' packed pools (on rank
       0's CPU); then CSC, 5 steps (the dense step, the ramp, one steady
       step at k = 616: the ring reduces the compacted wire buffer).
       Every bucket through the ring kernel, both ranks the same
       parameters after every step; each rank's peak device memory.
       Then (k), guarded lazy (``GuardConfig()``), 4 steps with a NaN
       written into rank 0's pool only at step 2: both ranks trip there
       and only there (the poison crossed the ring in-band), keep the same
       parameters, and launch the ring as often a step as unguarded.
   The numeric guard (``GuardConfig()``: loss scale 2^15), in the NCCL
   group, each fault 4096 pool elements wide, injected by the Trainer's
   fault hook after the pack:
   (g) lazy, staged, (a)'s settings, 8 steps on the stream: a NaN at step
       2, 2^120 at step 4, an exponent-MSB bit flip at step 6 (at least
       one flipped word must have been inside [2^-8, 2) and land at 2^119
       or more);
   (h) CSC, staged, (b)'s settings: a NaN in the dense warm-up step 0,
       2^120 in the steady step 5;
   (i) LARS, lazy, monolithic, (e)'s monolithic settings: a NaN at step
       2, 2^120 at step 4.
   In each, exactly the faulted steps trip; at each trip the parameters,
   the momentum and (CSC) hg and the chunk norms equal bit for bit the
   clones taken before the step; the scale halves at each trip from
   2^15; clean losses are finite; the dispatch counts equal the step
   plans' (a tripped step still launches its predicated updates); the
   clean steps' median time goes beside (a)'s, (b)'s and (e)'s.
   (j) GuardConfig(init_scale=1.0), no fault, against unguarded (twice):
       6 lazy steps on one repeated batch give the same losses and final
       parameters bit for bit (or, if the two unguarded runs differ,
       stay within their spread).
   The low-bit wires (``--wire-format``; lazy runs chunk the pool at
   32,768 as CSC does, so it has 7 buckets, the last padding only):
   (l) int8, lazy, staged, 6 + 6 steps: the pack takes the chunk census
       (``pool_pack``'s census path), 2 packs and 7 updates a step, 8
       all-reduces a step (7 buckets and the census sum), 134,561,832
       wire bytes a step against (a)'s 269,030,016 (analytic); on one
       step, on the device, dequant(q) + residual_new equals g +
       residual_old to f32 rounding;
   (m) int8, CSC, staged, 8 + 8 steps: the dense warm-up on the native
       wire, then k = 616 on int8 (20,201,512 wire bytes a step, the
       census included); on a steady step the residual moves at exactly
       the selected chunks;
   (n) fp8-e4m3, lazy, staged then monolithic, 6 + 6 steps each from one
       seed: the repeated batch's losses and final parameters the same
       bits, every parameter and the residual finite;
   (o) guarded int8 (``GuardConfig()``), lazy with (g)'s faults and CSC
       with (h)'s: exactly the faulted steps trip, each skip bit-identical
       on the device, the residual included, and the dispatch and
       all-reduce counts equal the step plans';
   (p) in (c)'s two processes over the ring: int8, lazy (3 + 3 steps) and
       CSC (5 steps); every lazy ring launch and every sparse CSC one
       carries int8 words (the dense warm-up bf16), the two ranks keep
       the same parameters.
   Each low-bit run's steady step time and peak memory go beside its bf16
   twin's of this call. Every run in the NCCL group also counts its
   ``dist.all_reduce`` calls against the step plans'.
   The training window as a CUDA graph (``Trainer.build_train_window``,
   in the NCCL group; the runs above pass ``--window-steps 1``, one
   eager step at a time):
   (q) lazy, (a)'s settings, a window of 8 steps: the first window
       (warm-up on scratch clones, capture, replay) the same losses and
       final parameters and momentum, bit for bit, as 8 eager steps of
       the CLI's loop from the same seed on the same batches; then 3
       replayed windows timed (step ms = window ms / 8, beside the eager
       steps'), the capture's and warm-up's host seconds, peak memory
       beside eager, the capture's launches against 8 x the plan's, the
       all-reduces of the first window (the warm-up body's and the
       capture's) and none in the replayed ones, the synchronizing
       calls of one window and its read (``set_sync_debug_mode``: 1)
       against an eager step's, and one window and two eager steps
       under ``torch.profiler``: the device's busy time and idle share,
       the kernels a step, the pool kernels' and the GEMMs' time;
   (r) (q) with ``pipeline_tail_buckets=2``: the same bits as (q)'s
       window, a flushed state; 4 head updates a step, 2 lane updates at
       each step's start and 2 at the flush (each with a pack of its
       span's masters), (q)'s all-reduces;
   (s) CSC through the CLI at ``--window-steps 4`` (``--csc-warmup 8``,
       24 steps: the snapped stages 1 and 2 run 4 steps each, the steady
       stage 4 four windows): one graph a stage, freed when the stage
       ends (one graph pool alive at each window's end), the capture's
       launches the stage plan's x 4, the losses of eager steps under
       the same snapped schedule bit for bit, the peak reserved memory
       under one graph's pool plus the state and its warm-up clone; the
       median step time of the steady stage's three replayed windows
       beside the eager twin's steady steps;
   (t) guarded lazy windows of 8 with (g)'s faults fired by the
       device-step hook inside the graph, unpipelined and with a tail of
       2: exactly steps 2, 4, 6 trip in the stacked ``guard_tripped``;
       an in-graph digest of the parameters and momentum shows each skip
       bit-identical (the rejected lane included); the losses (g)'s; the
       pipelined window the unpipelined one's bits;
   (u) in (c)'s two processes over the ring, a lazy window of 3 with a
       tail of 2, graphed on both ranks, on the lazy run's batches: the
       same losses as that eager run, the same parameters on both ranks
       after each window, every ring launch the warm-up body's or the
       capture's (the replays run the rest).
   ``GuardLane`` on the card (the ``guard_lane_windowed`` line), lazy and
   CSC: ``window=4`` gives the per-step records.
   Checkpoints, restarts, resume and elastic (smollm-135m at full
   width, bf16 wire, momentum SGD, kernels on):
   (v) lazy windows of 8, 32 steps under ``TrainSupervisor.run_windows``
       in the NCCL group, a checkpoint every 8, batches from a
       ``DataPipeline``, a host fault raised at step 20 after the window
       16-23 ran: one restart, restored to 16, saves at 8, 16, 24 and the
       final 32, one capture (the restore went into the live tensors)
       with the launches its plan says, every loss of the final pass and
       the final parameters and momentum bit for bit an uninterrupted
       32-step window run; save's blocking
       seconds, the writer's seconds, bytes a checkpoint, restore
       seconds, and the step time of windows with a write in flight
       against those without;
   (w) CSC through the CLI at ``--window-steps 4`` (``--csc-warmup 8``)
       in new processes, each with ``--steps 24``: one preempted by a
       SIGTERM after step 16 (its handler stops the run there, with the
       checkpoints at 8 and 16), then a process with the same flags
       resuming that directory at 16 to 24: its losses, and the SHA-256
       of every leaf of its final checkpoint (parameters, momentum, hg,
       chunk norms), those of an uninterrupted 24-step CLI run;
   (x) in (c)'s two processes over the ring, CSC at ``--window-steps
       1``, 12 steps under the supervisor with a collective checkpoint at
       8 (``hg`` [2, pool]); then this process restores step 8 into a
       host state of that layout, re-splits ``hg`` to one row
       (``reshard_hg``: the column total as numpy sums it), saves it at
       8, and a one-rank Trainer restores it in place (the re-split row
       and rank 0's parameters and momentum bit for bit, a one-rank plan
       key) and trains steps 8-11 on the same global batch, within
       ELASTIC_RTOL of the two ranks' losses, a bound that two controls
       (the restored hg zeroed, rank 0's row alone) exceed.
   Every checkpoint goes under a temporary directory of the script's
   (the CLI's default directory too), after a check that 16 GiB are
   free; it is emptied after each phase and removed at the end. Every
   CLI run must end with no restart of its supervisor.
   The kernels' dispatch counts are set to 0 just before each run and
   read just after: every kernel of the run's path must have launched,
   exactly as often as its step plans say, and no plain version may have
   run. Every loss must be finite and the repeated batch's last loss below
   its first.

Prints one JSON line per kernel, one for the NaN words, one for the
optimizer ops, one for the quantized ring, one per train run, the
windowed GuardLane's, the card's nvidia-smi line, the kernel summary line
(each kernel with ``in_graph``: whether a captured window launched it),
then ``{"ok": true, "device": {...}}`` as the last line.
Any failed check ends the run with a non-zero exit before that line.
Exits non-zero without a result when no CUDA device is visible.

    python3 chip_smoke.py --short-kernels [--src DIR]

runs only the device line, the build and the chunk_l1norm and csc_compact
phases, on the package under DIR/repro_torch (default: this tree's src):
a parent's checkout timed the same way as this tree, in one call. It
prints their JSON lines and the card's line, and no result line.
"""
from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 16
SEQ = 1024
BUCKET_ELEMS = 4_194_304
CHUNK = 32768
REPS, WARMUP = 20, 3
B2B = 20  # launches in one event region for the back-to-back times
LAZY_STEPS = 6
CSC_STEPS = 8
CSC_SPARSITY, CSC_WARMUP = 0.85, 4
CSC_KS = (616, 3233)  # the steady stage's k, and the first sparse stage's
# The CSC run's launches, from its step plans: 2 packs a step, 7 update
# spans a step, 1 census a step, 1 gather a sparse step.
CSC_COUNTS = {"pool_pack.kernel": 16, "pool_unpack_update.kernel": 56,
              "chunk_l1norm.kernel": 8, "csc_compact.kernel": 7}
# AdamW has no update kernel (plain PyTorch ops, as in the JAX package).
ADAMW_CSC_COUNTS = {k: v for k, v in CSC_COUNTS.items()
                    if k != "pool_unpack_update.kernel"}
# LARS's trust ratio (eta = 0.001) sets each tensor's step to about
# lr * 1e-3 of its norm: 0.5 % a step at 5.0, at which runs (d) and (e)
# check that the repeated batch's loss falls.
LARS_LR = 5.0
ADAMW_LR = 1e-3

# Device-memory bandwidth by card (NVIDIA data sheets), for the bounds.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores

UPDATE_LIBRARY_NOTE = ("no single PyTorch call computes this function "
                       "(e.g. torch._fused_sgd_ applies lr after the "
                       "momentum, not inside it)")
PACK_LIBRARY_NOTE = ("torch.cat(leaves [+ a zero tail for the padded pool], "
                     "out=staging): the pack without a census in one call; "
                     "timed only, the port never calls it")
CENSUS_LIBRARY_NOTE = ("torch.linalg.vector_norm(pool.view(C, chunk), ord=1, "
                       "dim=1); timed only, the port never calls it")
COMPACT_LIBRARY_NOTE = ("torch.index_select(pool.view(C, chunk), 0, idx); "
                        "timed only, the port never calls it")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def hbm_rate(name: str) -> float:
    for key in HBM_BYTES_PER_S:  # most specific names first
        if key in name:
            return HBM_BYTES_PER_S[key]
    fail(f"no memory bandwidth on record for {name!r}")


def bound_ms(nbytes: float, flops: float, rate: float):
    t_bytes, t_ops = nbytes / rate * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(torch, fn) -> float:
    """B2B launches in one event region, divided by B2B: the device's time
    a launch once the host's enqueue runs ahead of it (median of REPS
    regions after the warm-up)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2B):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / B2B)
    return statistics.median(times)


def enqueue_ms(torch, fn) -> float:
    """Host time to enqueue one launch on an idle device (median of REPS):
    above the kernel's time, it sets a launch timed alone."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def short_kernel_times(torch, kernel, library) -> dict:
    """A short kernel and its library call: per launch (``ms``,
    ``library_ms``, one launch an event region, comparable with earlier
    runs), back to back (B2B launches a region) and the host's enqueue."""
    return dict(ms=time_ms(torch, kernel),
                back_to_back_ms=back_to_back_ms(torch, kernel),
                enqueue_ms=enqueue_ms(torch, kernel),
                library_ms=time_ms(torch, library),
                library_back_to_back_ms=back_to_back_ms(torch, library),
                library_enqueue_ms=enqueue_ms(torch, library))


def max_rel(torch, got, want) -> float:
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry(name, source, replaces, parts, per_step, library_note, **extra):
    """One kernel's summary entry: the per-step sums of the CSC step's
    parts (``per_step`` names them), every part beside them."""
    sel = [parts[p] for p in per_step]
    lib = [p["library_ms"] for p in sel]
    bound_by = {p["bound_by"] for p in sel}
    check(len(bound_by) == 1, f"{name}: parts bound by {bound_by}")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=None, max_abs_err=max(p["max_abs_err"] for p in
                                       parts.values()),
        ms=sum(p["ms"] for p in sel), plain_ms=sum(p["plain_ms"] for p in sel),
        bound_ms=sum(p["bound_ms"] for p in sel), bound_by=bound_by.pop(),
        library_ms=None if None in lib else sum(lib),
        library_note=library_note, ported=True, per_step=list(per_step),
        parts=parts, **extra)


def pack_phase(torch, pool_mod, kpack, shapes, dev, rate):
    """pool_pack at the lazy and the CSC step's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = pool_mod.GradientPool(shapes)
    padded = pool_mod.GradientPool(shapes, pad_to=CHUNK)
    check(flat.padding == 0 and padded.size == 134_545_408,
          f"pool sizes {flat.size}, {padded.size}")
    grads = [torch.randn(s, generator=gen, device=dev) for s in flat.sizes]
    params = [torch.randn(s, generator=gen, device=dev) for s in flat.sizes]
    parts = {}
    for label, pool, leaves, wire in (
            ("lazy_grads_to_bf16", flat, grads, torch.bfloat16),
            ("lazy_params_to_f32", flat, params, torch.float32),
            ("csc_grads_to_f32_padded", padded, grads, torch.float32),
            ("csc_params_to_f32_padded", padded, params, torch.float32)):
        n, covered = pool.size, pool.unpadded_size
        args = (leaves, pool.offsets, pool.sizes, n, 0, wire)
        staging = torch.full((n,), 7.0, dtype=wire, device=dev)
        got, _ = kpack.launch(*args, out=staging)
        want, _ = kpack.plain(*args)
        torch.cuda.synchronize()
        check(got.data_ptr() == staging.data_ptr(), "pack ignored staging")
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"pool_pack {label}: kernel != plain "
              f"(max abs diff {err})")
        ms = time_ms(torch, lambda: kpack.launch(*args, out=staging))
        plain_ms = time_ms(torch, lambda: kpack.plain(*args))
        # The library yardstick: one torch.cat into the staging buffer,
        # with a zero tail as its last input where the pool is padded.
        tail = [torch.zeros(pool.padding, dtype=wire, device=dev)] \
            if pool.padding else []
        lib = torch.full((n,), 7.0, dtype=wire, device=dev)
        torch.cat(leaves + tail, out=lib)
        torch.cuda.synchronize()
        check(torch.equal(lib, want), f"torch.cat {label} != plain pack")
        library_ms = time_ms(torch, lambda: torch.cat(leaves + tail, out=lib))
        nbytes = covered * 4 + n * torch.empty((), dtype=wire).element_size()
        b_ms, b_by = bound_ms(nbytes, covered, rate)
        parts[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            max_abs_err=err)
        del got, want, staging, lib, tail
    # The padded table with the chunk census (the quantized-wire form).
    got, norms = kpack.launch(grads, padded.offsets, padded.sizes,
                              padded.size, CHUNK, torch.bfloat16)
    want, want_n = kpack.plain(grads, padded.offsets, padded.sizes,
                               padded.size, CHUNK, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "pool_pack census pool: kernel != plain")
    census_rel = max_rel(torch, norms, want_n)
    check(census_rel <= 1e-6, f"pool_pack census rel err {census_rel}")
    ms_census = time_ms(torch, lambda: kpack.launch(
        grads, padded.offsets, padded.sizes, padded.size, CHUNK,
        torch.bfloat16))
    del got, want, norms, want_n, grads, params
    torch.cuda.empty_cache()
    return entry("pool_pack", "src/repro_torch/kernels/csrc/pool_pack.cu",
                 "src/repro/kernels/pool_pack.py:134", parts,
                 ("csc_grads_to_f32_padded", "csc_params_to_f32_padded"),
                 PACK_LIBRARY_NOTE, census_ms=ms_census,
                 census_max_rel_err=census_rel)


def update_phase(torch, pool_mod, csc, kunpack, shapes, dev, rate):
    """pool_unpack_update over lazy's 6 spans and CSC's 7 (with ratios on
    one lazy span), and over the whole padded CSC pool in one launch with
    per-tensor ratios (LARS monolithic)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    lr = torch.tensor(0.2, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, weight_decay=1e-4)
    parts = {}
    for label, pool in (("lazy_6_spans", pool_mod.GradientPool(shapes)),
                        ("csc_7_spans",
                         pool_mod.GradientPool(shapes, pad_to=CHUNK))):
        n = pool.size
        views = [pool.bucket_view(s, e)
                 for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
        master = torch.randn(n, generator=gen, device=dev)
        grads = torch.randn(n, generator=gen, device=dev) * 1e-2
        mom = torch.randn(n, generator=gen, device=dev) * 1e-2
        if label.startswith("lazy"):
            check(len(views) == 6, f"{len(views)} lazy spans, expected 6")
            masks = {"all-true mask": torch.ones(n, dtype=torch.bool,
                                                 device=dev),
                     "random mask": torch.rand(n, generator=gen,
                                               device=dev) < 0.7}
        else:
            check(len(views) == 7 and views[-1].num_tensors == 0,
                  f"CSC spans {[(v.start, v.num_tensors) for v in views]}")
            norms = torch.rand(n // CHUNK, generator=gen, device=dev)
            _, chunk_mask = csc.select_chunks(norms, CSC_KS[0])
            masks = {"chunk mask": csc.element_mask(chunk_mask, CHUNK)}
        timed_mask = next(iter(masks.values()))

        def outputs():
            return ([torch.empty(s, device=dev) for s in pool.sizes],
                    torch.empty(n, device=dev))

        k_out, p_out = outputs(), outputs()

        def step(fn, out, mask):
            leaves, mom_out = out
            for v in views:
                s, e = v.start, v.end
                fn(master[s:e], grads[s:e], mom[s:e], mask[s:e], v.offsets,
                   v.sizes, out_leaves=leaves[v.leaf_lo:v.leaf_hi],
                   out_momentum=mom_out[s:e], **kw)

        err = 0.0
        for mlabel, mask in masks.items():
            step(kunpack.launch, k_out, mask)
            step(kunpack.plain, p_out, mask)
            torch.cuda.synchronize()
            for a, b in zip(k_out[0] + [k_out[1]], p_out[0] + [p_out[1]]):
                d = (a - b).abs().max().item()
                err = max(err, d)
                check(torch.equal(a, b), f"pool_unpack_update ({label}, "
                      f"{mlabel}): kernel != plain (max abs diff {d})")
        if label.startswith("lazy"):
            # Per-tensor ratios on one span (LARS staged, lazy).
            v = views[0]
            r = torch.rand(v.num_tensors, generator=gen, device=dev)
            args = (master[:v.size], grads[:v.size], mom[:v.size],
                    masks["random mask"][:v.size], v.offsets, v.sizes)
            a = kunpack.launch(*args, ratios=r, **kw)
            b = kunpack.plain(*args, ratios=r, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y)
                      for x, y in zip(a[0] + [a[1]], b[0] + [b[1]])),
                  "pool_unpack_update with ratios: kernel != plain")
        else:
            # LARS monolithic: the whole padded pool in one launch, with
            # f32[T+1] ratios (the trailing entry is the padding's).
            r = torch.rand(pool.num_tensors + 1, generator=gen, device=dev)
            mask = masks["chunk mask"]

            def whole(fn, out):
                fn(master, grads, mom, mask, pool.offsets, pool.sizes,
                   ratios=r, out_leaves=out[0], out_momentum=out[1], **kw)

            whole(kunpack.launch, k_out)
            whole(kunpack.plain, p_out)
            torch.cuda.synchronize()
            w_err = max((a - b).abs().max().item()
                        for a, b in zip(k_out[0] + [k_out[1]],
                                        p_out[0] + [p_out[1]]))
            check(all(torch.equal(a, b) for a, b in
                      zip(k_out[0] + [k_out[1]], p_out[0] + [p_out[1]])),
                  f"pool_unpack_update, whole CSC pool with ratios: kernel "
                  f"!= plain (max abs diff {w_err})")
            nbytes = n * 17 + pool.unpadded_size * 4 + r.numel() * 4
            b_ms, b_by = bound_ms(nbytes, n * 7, rate)
            parts["csc_whole_pool_ratios"] = dict(
                ms=time_ms(torch, lambda: whole(kunpack.launch, k_out)),
                plain_ms=time_ms(torch, lambda: whole(kunpack.plain, p_out)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                max_abs_err=w_err, launches_per_step=1)
            parts.update(ok_predicate_parts(torch, kunpack, pool, master,
                                            grads, mom, mask, r, k_out, kw,
                                            (b_ms, b_by, nbytes), rate, dev))
        ms = time_ms(torch, lambda: step(kunpack.launch, k_out, timed_mask))
        plain_ms = time_ms(torch, lambda: step(kunpack.plain, p_out,
                                               timed_mask))
        # Reads master, grads, momentum (4 B) and the mask (1 B); writes
        # the momentum and, where a leaf owns the element, the leaf.
        nbytes = n * 17 + pool.unpadded_size * 4
        b_ms, b_by = bound_ms(nbytes, n * 7, rate)
        parts[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            max_abs_err=err, launches_per_step=len(views))
        del master, grads, mom, masks, timed_mask, k_out, p_out
        torch.cuda.empty_cache()
    return entry("pool_unpack_update",
                 "src/repro_torch/kernels/csrc/pool_unpack.cu",
                 "src/repro/kernels/pool_unpack.py:132", parts,
                 ("csc_7_spans",), UPDATE_LIBRARY_NOTE)


def ok_predicate_parts(torch, kunpack, pool, master, grads, mom, mask, r,
                       want, kw, bound, rate, dev):
    """The guard's ``ok`` on the whole-pool launch with ratios, writing
    into live leaves and the momentum in place: ok = true gives ``want``
    (the launch without ok) bit for bit; ok = false, fed NaN gradients,
    writes nothing. Both timed beside the plain version."""
    ok_t = torch.ones(1, dtype=torch.bool, device=dev)
    ok_f = torch.zeros(1, dtype=torch.bool, device=dev)
    live = ([torch.full((s,), 7.0, device=dev) for s in pool.sizes],
            mom.clone())

    def guarded(fn, ok, g):
        fn(master, g, live[1], mask, pool.offsets, pool.sizes, ratios=r,
           out_leaves=live[0], out_momentum=live[1], ok=ok, **kw)

    guarded(kunpack.launch, ok_t, grads)
    torch.cuda.synchronize()
    check(all(bits_equal(torch, a, b) for a, b in
              zip(live[0] + [live[1]], want[0] + [want[1]])),
          "pool_unpack_update with ok = true != the launch without ok")
    nan = torch.full_like(grads, float("nan"))
    before = [x.clone() for x in live[0] + [live[1]]]
    guarded(kunpack.launch, ok_f, nan)
    torch.cuda.synchronize()
    check(all(bits_equal(torch, a, b) for a, b in
              zip(live[0] + [live[1]], before)),
          "pool_unpack_update with ok = false wrote its outputs")
    del before
    b_ms, b_by, nbytes = bound
    # The same in-place launch without and with ok = true, timed in turns
    # (without, with, with, without): the predicate's cost, if any.
    pair = {None: [], True: []}
    for flag in (None, True, True, None):
        pair[flag].append(time_ms(torch, lambda: guarded(
            kunpack.launch, ok_t if flag else None, grads)))
    out = {"csc_whole_pool_ratios_ok_true": dict(
        ms=statistics.mean(pair[True]),
        ms_without_ok_same_calls=statistics.mean(pair[None]),
        ms_turns=[pair[None][0], pair[True][0], pair[True][1],
                  pair[None][1]],
        plain_ms=time_ms(torch, lambda: guarded(kunpack.plain, ok_t, grads)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        max_abs_err=0.0)}
    # ok = false reads one byte a CTA and writes nothing: its device time
    # hides under the host's enqueue, so back to back and the enqueue too.
    f_ms, f_by = bound_ms(1, 0, rate)

    def skip():
        guarded(kunpack.launch, ok_f, nan)

    out["csc_whole_pool_ratios_ok_false"] = dict(
        ms=time_ms(torch, skip), back_to_back_ms=back_to_back_ms(torch, skip),
        enqueue_ms=enqueue_ms(torch, skip),
        plain_ms=time_ms(torch, lambda: guarded(kunpack.plain, ok_f, nan)),
        library_ms=None, bound_ms=f_ms, bound_by=f_by, bytes=1,
        max_abs_err=0.0)
    del live, nan
    return out


def census_phase(torch, kcl, num_chunks, dev, rate, grids=True):
    """chunk_l1norm on the CSC pool, f32 (the path's form) and bf16; with
    ``grids``, the f32 census also at a grid of 77 CTAs (the same bits)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    n = num_chunks * CHUNK
    pool = torch.randn(n, generator=gen, device=dev)
    parts = {}
    for label, x in (("f32", pool), ("bf16", pool.to(torch.bfloat16))):
        got = kcl.launch(x, CHUNK)
        again = kcl.launch(x, CHUNK)
        want = kcl.plain(x, CHUNK)
        lib = torch.linalg.vector_norm(x.view(num_chunks, CHUNK).float()
                                       if label == "bf16" else
                                       x.view(num_chunks, CHUNK), ord=1,
                                       dim=1)
        torch.cuda.synchronize()
        # The same |x| summed in another order: f32 rounding only, 1e-6
        # against the plain sum. vector_norm's order is its own (on the
        # CPU it differs from the plain sum by 1.4e-6): 1e-5 there.
        rel, rel_lib = max_rel(torch, got, want), max_rel(torch, got, lib)
        check(rel <= 1e-6, f"chunk_l1norm {label}: rel err {rel} vs plain")
        check(rel_lib <= 1e-5, f"chunk_l1norm {label}: rel err {rel_lib} "
              f"vs torch.linalg.vector_norm")
        check(torch.equal(got, again),
              f"chunk_l1norm {label}: two launches differ")
        part = dict(max_abs_err=(got - want).abs().max().item(),
                    max_rel_err=rel, max_rel_err_library=rel_lib)
        if grids and label == "f32":
            other = kcl.launch(x, CHUNK, grid=77)
            torch.cuda.synchronize()
            check(torch.equal(got, other),
                  f"chunk_l1norm {label}: the norms differ at 77 CTAs")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            part["plan"] = kcl.plan(num_chunks, CHUNK, 4, 16, sms)
            del other
        if label == "f32":
            part.update(short_kernel_times(
                torch, lambda: kcl.launch(x, CHUNK),
                lambda: torch.linalg.vector_norm(x.view(num_chunks, CHUNK),
                                                 ord=1, dim=1)))
            part["plain_ms"] = time_ms(torch, lambda: kcl.plain(x, CHUNK))
            nbytes = n * 4 + num_chunks * 4
            part["bound_ms"], part["bound_by"] = bound_ms(nbytes, 2 * n,
                                                          rate)
            part["bytes"] = nbytes
        parts[label] = part
        del got, again, want, lib
    del pool
    torch.cuda.empty_cache()
    return entry("chunk_l1norm",
                 "src/repro_torch/kernels/csrc/chunk_l1norm.cu",
                 "src/repro/kernels/chunk_l1norm.py:50", parts, ("f32",),
                 CENSUS_LIBRARY_NOTE)


def compact_phase(torch, kcc, num_chunks, dev, rate, grids=True):
    """csc_compact on the CSC pool at the steady and the first sparse k;
    with ``grids``, also at a grid of 77 CTAs (the same bytes)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = torch.randn(num_chunks * CHUNK, generator=gen, device=dev)
    parts = {}
    for k in CSC_KS:
        idx = torch.sort(torch.randperm(num_chunks, generator=gen,
                                        device=dev)[:k]).values
        got = kcc.launch(pool, idx, CHUNK)
        want = kcc.plain(pool, idx, CHUNK)
        lib = torch.index_select(pool.view(num_chunks, CHUNK), 0, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"csc_compact k={k}: kernel != plain")
        check(torch.equal(got, lib.reshape(-1)),
              f"csc_compact k={k}: kernel != torch.index_select")
        part = dict(max_abs_err=(got - want).abs().max().item())
        if grids:
            other = kcc.launch(pool, idx, CHUNK, grid=77)
            torch.cuda.synchronize()
            check(torch.equal(got, other),
                  f"csc_compact k={k}: kernel at 77 CTAs != plain")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            part["plan"] = kcc.plan(k, num_chunks, CHUNK * 4, 4, 16, sms)
            del other
        nbytes = 2 * k * CHUNK * 4 + k * 8
        b_ms, b_by = bound_ms(nbytes, 0, rate)
        part.update(short_kernel_times(
            torch, lambda: kcc.launch(pool, idx, CHUNK),
            lambda: torch.index_select(pool.view(num_chunks, CHUNK), 0, idx)))
        part.update(plain_ms=time_ms(torch, lambda: kcc.plain(pool, idx,
                                                              CHUNK)),
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        parts[f"k={k}"] = part
        del got, want, lib
    del pool
    torch.cuda.empty_cache()
    return entry("csc_compact", "src/repro_torch/kernels/csrc/csc_compact.cu",
                 "src/repro/kernels/csc_compact.py:39", parts,
                 (f"k={CSC_KS[0]}",), COMPACT_LIBRARY_NOTE)


RING_NS = (2, 4, 8)
RING_LIBRARY_NOTE = ("torch.stack(xs).float().sum(0): the same sum in one "
                     "call, without the ring's wire rounding (so not the "
                     "same bits); timed only, the port never calls it")
FUSED_LIBRARY_NOTE = ("no single PyTorch call computes this function (e.g. "
                      "torch._fused_sgd_ applies lr after the momentum, not "
                      "inside it)")


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def abs_err(a, b) -> float:
    """Largest |a - b| over elements where both are numbers."""
    return (a.float() - b.float()).abs().nan_to_num(0.0).max().item()


def ring_inputs(torch, n, size, dtype, gen, dev):
    """N ranks' inputs: f32/bf16 normal; int8 words within 127 // N (on
    the grid); fp8 words anywhere in ±448, so the sums overflow the
    format and its overflow rule is exercised."""
    if dtype == torch.int8:
        q = 127 // n
        return [torch.randint(-q, q + 1, (size,), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(n)]
    if dtype == torch.float8_e4m3fn:
        return [((torch.rand(size, generator=gen, device=dev) - 0.5) * 896
                 ).to(dtype) for _ in range(n)]
    return [torch.randn(size, generator=gen, device=dev).to(dtype)
            for _ in range(n)]


def ring_phase(torch, kring, pool_mod, shapes, dev, rate):
    """ring_allreduce with N = 2, 4, 8 ranks in this process, each rank on
    its own stream (the in-process workspace): smollm-135m's 6 lazy
    buckets, the whole lazy pool and the CSC steady wire buffer in bf16,
    and the first bucket in f32, int8 and fp8-e4m3; bit for bit against
    the plain ring with the kernel's segment, every rank the same bits."""
    pool = pool_mod.GradientPool(shapes)
    buckets = pool.bucket_boundaries(BUCKET_ELEMS)
    check(len(buckets) == 6, f"{len(buckets)} lazy buckets, expected 6")
    first = buckets[0][1] - buckets[0][0]
    cases = ([(f"lazy_bucket_{i}", e - s, torch.bfloat16)
              for i, (s, e) in enumerate(buckets)]
             + [("lazy_pool", pool.size, torch.bfloat16),
                (f"csc_wire_k{CSC_KS[0]}", CSC_KS[0] * CHUNK, torch.bfloat16),
                ("lazy_bucket_0_f32", first, torch.float32),
                ("lazy_bucket_0_int8", first, torch.int8),
                ("lazy_bucket_0_fp8", first, torch.float8_e4m3fn)])
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = {}
    for n in RING_NS:
        ws = kring.RingWorkspace.in_process(n, dev)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        for label, size, dt in cases:
            xs = ring_inputs(torch, n, size, dt, gen, dev)
            p = kring.plan(size, n, dt, sms=sms)
            got = kring.launch_ranks(xs, ws, streams=streams)
            want = kring.plain(xs, None, p["seg_elems"])
            torch.cuda.synchronize()
            for r in range(n):
                check(bits_equal(torch, got[r], want[r]),
                      f"ring_allreduce N={n} {label} rank {r}: kernel != "
                      f"plain (max abs diff {abs_err(got[r], want[r])})")
                check(bits_equal(torch, got[r], got[0]),
                      f"ring_allreduce N={n} {label}: ranks differ")
            err = max(abs_err(g, w) for g, w in zip(got, want))
            if label == "lazy_bucket_0":
                # In place (out = x), as the trainer calls it.
                same = [x.clone() for x in xs]
                kring.launch_ranks(same, ws, outs=same, streams=streams)
                torch.cuda.synchronize()
                check(all(bits_equal(torch, a, w) for a, w in zip(same, want)),
                      f"ring_allreduce N={n} {label} in place: kernel != "
                      f"plain")
                del same
            del want
            ms = time_ms(torch, lambda: kring.launch_ranks(
                xs, ws, outs=got, streams=streams))
            # Host time to enqueue the N launches (streams, events, ctypes).
            enqueue = enqueue_ms(torch, lambda: kring.launch_ranks(
                xs, ws, outs=got, streams=streams))
            plain_ms = time_ms(torch, lambda: kring.plain(
                xs, None, p["seg_elems"]))
            library_ms = time_ms(torch, lambda: torch.stack(xs).float()
                                 .sum(0))
            # All N ranks share one device memory: count every rank.
            nbytes = n * kring.bound_bytes(size, n, dt, dt)
            b_ms, b_by = bound_ms(nbytes, n * (n - 1) * -(-size // n), rate)
            parts[f"N={n} {label}"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
                enqueue_ms=enqueue,
                elems=size, ranks=n, lanes=p["lanes"],
                seg_elems=p["seg_elems"], rounds=p["rounds"],
                dtype=str(dt).split(".")[-1])
            del xs, got
            torch.cuda.empty_cache()
        if n == 2:
            # The 6 lazy buckets launched back to back, as a training step
            # launches them: the host's enqueue of a bucket overlaps the
            # ring before it.
            bufs = [ring_inputs(torch, n, e - s, torch.bfloat16, gen, dev)
                    for s, e in buckets]
            outs = [[torch.empty_like(x) for x in b] for b in bufs]

            def six():
                for b, o in zip(bufs, outs):
                    kring.launch_ranks(b, ws, outs=o, streams=streams)
            back_to_back_ms = time_ms(torch, six)
            del bufs, outs
        del ws
        torch.cuda.empty_cache()
    return entry("ring_allreduce",
                 "src/repro_torch/kernels/csrc/ring_reduce.cu",
                 "src/repro/kernels/ring_reduce.py:302", parts,
                 tuple(f"N=2 lazy_bucket_{i}" for i in range(6)),
                 RING_LIBRARY_NOTE, fp8_saturates=kring.fp8_saturates(),
                 lazy_buckets_back_to_back_ms=back_to_back_ms,
                 note=("ms is the N ranks' launches together on one card: "
                       "the ring runs through this card's memory, not "
                       "over NVLink"))


def nan_word(torch, x) -> str:
    """The bits of the first NaN word of ``x`` in hex, or None."""
    at = torch.isnan(x.float()).nonzero()
    if at.numel() == 0:
        return None
    bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
    word = int(x.view(bits)[at[0, 0]].item()) & (2 ** (8 * x.element_size())
                                                  - 1)
    return f"0x{word:0{2 * x.element_size()}X}"


def same_class(torch, got, want) -> bool:
    """NaN where ``want`` has NaN (any NaN word), the same bits
    elsewhere."""
    nan = torch.isnan(want.float())
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return (torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(got.view(bits)[~nan], want.view(bits)[~nan]))


def nonfinite_phase(torch, kpack, kcl, kring, pool_mod, shapes, dev):
    """The words the guard feeds the kernels: NaN, +-Inf and 2^120 in
    smollm-135m's gradient leaves through the lazy pack (f32 -> bf16) and
    the CSC pack (f32 -> f32, padded), the census of the CSC pool, and
    the ring at N = 2 on the first lazy bucket with a NaN and 2^120 on
    rank 0 and an Inf on rank 1; each against its plain version, NaN by
    class. Records the NaN word each one emits."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flat = pool_mod.GradientPool(shapes)
    padded = pool_mod.GradientPool(shapes, pad_to=CHUNK)
    grads = [torch.randn(sz, generator=gen, device=dev) * 1e-3
             for sz in flat.sizes]
    specials = ((0, 5, float("nan")), (1, 7, float("inf")),
                (3, 11, -float("inf")), (5, 13, 2.0 ** 120),
                (10, 17, float("nan")))
    for leaf, at, v in specials:
        grads[leaf][at] = v
    words = {}
    for label, pool, wire in (("lazy_bf16", flat, torch.bfloat16),
                              ("csc_f32", padded, torch.float32)):
        args = (grads, pool.offsets, pool.sizes, pool.size, 0, wire)
        got, _ = kpack.launch(*args)
        want, _ = kpack.plain(*args)
        torch.cuda.synchronize()
        check(same_class(torch, got, want),
              f"pool_pack {label} with NaN/Inf/2^120: kernel != plain")
        words[f"pool_pack {label}"] = nan_word(torch, got)
        words[f"plain pack {label}"] = nan_word(torch, want)
        if label == "csc_f32":
            norms, want_n = kcl.launch(got, CHUNK), kcl.plain(got, CHUNK)
            torch.cuda.synchronize()
            fin = torch.isfinite(want_n)
            bad = {(pool.offsets[leaf] + at) // CHUNK
                   for leaf, at, v in specials if not math.isfinite(v)}
            check(torch.equal(torch.isnan(norms), torch.isnan(want_n))
                  and torch.equal(torch.isinf(norms), torch.isinf(want_n))
                  and int((~fin).sum()) == len(bad),
                  "chunk_l1norm with NaN/Inf: classes differ from plain")
            rel = max_rel(torch, norms[fin], want_n[fin])
            check(rel <= 1e-6, f"chunk_l1norm with 2^120: rel err {rel}")
            words["chunk_l1norm"] = nan_word(torch, norms)
            words["plain census"] = nan_word(torch, want_n)
        del got, want
    del grads
    bucket = flat.bucket_boundaries(BUCKET_ELEMS)[0]
    size = bucket[1] - bucket[0]
    xs = ring_inputs(torch, 2, size, torch.bfloat16, gen, dev)
    xs[0][123] = float("nan")
    xs[0][size // 2] = 2.0 ** 120
    xs[1][size - 5] = float("inf")
    ws = kring.RingWorkspace.in_process(2, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = kring.plan(size, 2, torch.bfloat16, sms=sms)
    got = kring.launch_ranks(xs, ws)
    want = kring.plain(xs, None, p["seg_elems"])
    torch.cuda.synchronize()
    for r in range(2):
        check(same_class(torch, got[r], want[r])
              and bits_equal(torch, got[r], got[0])
              and bool(torch.isnan(got[r][123].float()))
              and bool(torch.isinf(got[r][size - 5].float())),
              f"ring_allreduce N=2 with NaN/Inf on rank {r}: != plain by "
              f"class")
    words["ring_allreduce bf16"] = nan_word(torch, got[0])
    words["plain ring bf16"] = nan_word(torch, want[0])
    del xs, got, want, ws
    torch.cuda.empty_cache()
    return words


def fused_update_phase(torch, kfu, optim, ops, base, dev, rate):
    """fused_update on the whole 134,515,008-element f32 pool, all-true
    and random mask, each with and without the scale, bit for bit against
    the plain version; then ``optim.update_pool`` (the entry point that
    reaches it) driven for 3 steps with the counts set to 0 just before."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 134_515_008
    master = torch.randn(n, generator=gen, device=dev)
    grads = torch.randn(n, generator=gen, device=dev) * 1e-2
    mom = torch.randn(n, generator=gen, device=dev) * 1e-2
    scale = torch.rand(n, generator=gen, device=dev) + 0.5
    masks = {"all-true mask": torch.ones(n, dtype=torch.bool, device=dev),
             "random mask": torch.rand(n, generator=gen, device=dev) < 0.7}
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4)
    parts = {}
    for mlabel, mask in masks.items():
        for slabel, s in (("no scale", None), ("scale", scale)):
            args = (master, grads, mom, mask)
            got = kfu.launch(*args, scale=s, **kw)
            want = kfu.plain(*args, scale=s, **kw)
            torch.cuda.synchronize()
            err = max(abs_err(a, b) for a, b in zip(got, want))
            check(all(bits_equal(torch, a, b) for a, b in zip(got, want)),
                  f"fused_update ({mlabel}, {slabel}): kernel != plain "
                  f"(max abs diff {err})")
            del got, want
            nbytes = n * (25 if s is not None else 21)
            b_ms, b_by = bound_ms(nbytes, n * 7, rate)
            parts[f"{mlabel}, {slabel}"] = dict(
                ms=time_ms(torch, lambda: kfu.launch(*args, scale=s, **kw)),
                plain_ms=time_ms(torch, lambda: kfu.plain(*args, scale=s,
                                                          **kw)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                max_abs_err=err)
            torch.cuda.empty_cache()
    cfg = base.OptimizerConfig(learning_rate=0.05, momentum=0.9,
                               weight_decay=1e-4)
    state = optim.SGDState(momentum=mom)
    w = master
    ops.reset_counts()
    for _ in range(3):
        w, state = optim.update_pool("momentum_sgd", w, grads, state,
                                     masks["random mask"], cfg, kw["lr"],
                                     use_kernels=True)
    torch.cuda.synchronize()
    counts = dict(ops.dispatch_counts)
    check(counts == {"fused_update.kernel": 3},
          f"optim.update_pool: dispatch counts {counts}")
    check(bool(torch.isfinite(w).all()), "optim.update_pool: non-finite")
    del master, grads, mom, scale, masks, w, state
    torch.cuda.empty_cache()
    return entry("fused_update",
                 "src/repro_torch/kernels/csrc/fused_update.cu",
                 "src/repro/kernels/fused_update.py:73", parts,
                 ("all-true mask, no scale",), FUSED_LIBRARY_NOTE,
                 launches_update_pool=counts["fused_update.kernel"])


def optimizer_phase(torch, pool_mod, csc, optim, lars_mod, base, shapes,
                    dev, rate):
    """LARS's trust ratios and AdamW's update are PyTorch ops in the port,
    as they are jnp in the JAX package: no kernel, so no kernel entry.
    Timed here beside their bytes bounds: one step's LARS ratios over the
    lazy spans (no mask) and over CSC's spans (the chunk mask zeroes the
    unselected gradients), each equal to the whole-pool ratios; one AdamW
    update sweep over CSC's 7 spans (``optim.update_view``, as the staged
    engine runs it)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    lars_cfg = base.OptimizerConfig(name="lars", learning_rate=LARS_LR)
    out = {}
    for label, pool in (("lazy_6_spans", pool_mod.GradientPool(shapes)),
                        ("csc_7_spans",
                         pool_mod.GradientPool(shapes, pad_to=CHUNK))):
        n = pool.size
        views = [pool.bucket_view(s, e)
                 for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
        master = torch.randn(n, generator=gen, device=dev)
        grads = torch.randn(n, generator=gen, device=dev) * 1e-2
        mask = None
        if label.startswith("csc"):
            norms = torch.rand(n // CHUNK, generator=gen, device=dev)
            mask = csc.element_mask(csc.select_chunks(norms, CSC_KS[0])[1],
                                    CHUNK)
        lars = lars_mod.LARSScaler(pool)

        def ratios():
            return [lars.ratios_view(
                v, master[v.start:v.end], grads[v.start:v.end], lars_cfg,
                None if mask is None else mask[v.start:v.end])
                for v in views]

        spans = torch.cat(ratios())
        whole = lars.ratios(master, grads, lars_cfg, mask)
        torch.cuda.synchronize()
        check(spans.shape == (pool.num_tensors,)
              and bool(torch.isfinite(spans).all()),
              f"LARS ratios {label}: {spans}")
        rel = max_rel(torch, spans, whole[:pool.num_tensors])
        check(rel <= 1e-6, f"LARS ratios {label}: per span != whole pool "
              f"(rel err {rel})")
        nbytes = n * 8 + (n if mask is not None else 0)
        b_ms, b_by = bound_ms(nbytes, 4 * n, rate)
        out[f"lars_ratios_{label}"] = dict(
            ms=time_ms(torch, ratios), bound_ms=b_ms, bound_by=b_by,
            bytes=nbytes, ratios=spans.tolist())
        if label.startswith("csc"):
            adamw_cfg = base.OptimizerConfig(name="adamw",
                                              learning_rate=ADAMW_LR)
            state = optim.init_state("adamw", n, dev)
            leaves = [torch.empty(sz, device=dev) for sz in pool.sizes]
            lr = torch.tensor(ADAMW_LR, device=dev)

            def sweep():
                for v in views:
                    s, e = v.start, v.end
                    optim.update_view(
                        "adamw", v, master[s:e], grads[s:e],
                        optim.AdamWState(*(x[s:e] for x in state)),
                        mask[s:e], adamw_cfg, lr,
                        out_leaves=leaves[v.leaf_lo:v.leaf_hi])

            sweep()
            torch.cuda.synchronize()
            check(torch.equal(state.counts, mask.to(torch.int32))
                  and all(bool(torch.isfinite(x).all()) for x in leaves),
                  "AdamW sweep: counts or leaves wrong after one sweep")
            # Reads master, grads, mu, nu, counts (4 B) and the mask (1 B);
            # writes mu, nu, counts and, where a leaf owns the element, the
            # leaf.
            nbytes = n * 33 + pool.unpadded_size * 4
            b_ms, b_by = bound_ms(nbytes, 20 * n, rate)
            out["adamw_update_csc_7_spans"] = dict(
                ms=time_ms(torch, sweep), bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes)
            del state, leaves
        del master, grads, mask
        torch.cuda.empty_cache()
    return out


def expected_counts(trainer, steps, first=0):
    """The kernel launches ``steps`` steps of this trainer's paths from
    step ``first`` on need, from its step plans: 2 packs a step; the SGD
    and LARS updates one a span (staged) or one a step (monolithic),
    AdamW's none; CSC's census one a step and its gather one a sparse
    step."""
    gf = trainer.gf
    plans = [gf.plan(gf.stage_for_step(s))
             for s in range(first, first + steps)]
    want = {"pool_pack.kernel": 2 * steps}
    if trainer.opt_name != "adamw":  # AdamW has no update kernel
        want["pool_unpack_update.kernel"] = steps \
            if gf.cfg.overlap == "monolithic" \
            else sum(len(p.update_spans) for p in plans)
    if gf.cfg.csc_enabled:
        sparse = sum(not p.warmup for p in plans)
        # A low-bit sparse step also takes the wire buffer's send census.
        want["chunk_l1norm.kernel"] = steps + (
            sparse if gf.wire_spec is not None else 0)
        want["csc_compact.kernel"] = sparse
    return want


def expected_collectives(trainer, steps):
    """The all-reduces ``steps`` steps issue, from the step plans
    (``GradientFlow.num_collectives``: the buckets, CSC's norm census,
    the low-bit dense and lazy census sum); in a world-size-1 group every
    one is a ``dist.all_reduce`` and the metrics take none."""
    gf = trainer.gf
    return sum(gf.num_collectives(gf.stage_for_step(s))
               for s in range(steps))


class CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls while entered."""

    def __init__(self, dist):
        self.dist, self.calls = dist, 0

    def __enter__(self):
        self.original = self.dist.all_reduce

        def counted(*args, **kwargs):
            self.calls += 1
            return self.original(*args, **kwargs)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.original


def count_ratio_launches(kunpack):
    """Wrap ``kunpack.launch`` (which ``ops.pool_unpack_update`` calls) to
    tally its launches with and without ``ratios``. Returns (tally,
    restore)."""
    launch = kunpack.launch
    tally = {"with_ratios": 0, "without_ratios": 0}

    def counted(*args, ratios=None, **kwargs):
        tally["with_ratios" if ratios is not None else "without_ratios"] += 1
        return launch(*args, ratios=ratios, **kwargs)

    def restore():
        kunpack.launch = launch

    kunpack.launch = counted
    return tally, restore


def stream_steps(torch, trainer, cfg, seed, steps):
    """``steps`` steps on the synthetic stream, as the CLI's loop runs them
    (``repro_torch.launch.train.train``), for a Trainer the CLI cannot
    build (``overlap='monolithic'`` has no flag). Returns (losses, step
    seconds)."""
    from repro_torch.data.synthetic import SyntheticLM
    data = SyntheticLM(cfg.model.vocab_size, seed=seed)
    state = trainer.init_state(seed)
    fns, losses, seconds = {}, [], []
    for s in range(steps):
        stage = trainer.gf.stage_for_step(s)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        batch = data.batch(s, cfg.global_batch, cfg.seq_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = fns[stage.index](state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, seconds


def train_run(torch, ops, train_mod, synthetic, label, argv, steps,
              overlap="staged", keep_params=False, watch=None):
    """(a) ``steps`` steps on the synthetic stream, timed: the CLI's loop,
    or with ``overlap='monolithic'`` the same loop on a Trainer built with
    it; and (b) ``steps`` steps of such a Trainer on ONE batch, each step
    under the stage the CLI would pick. On a fresh batch each step, a few
    steps at the CLI's learning rate move the loss less than the
    batch-to-batch spread, so (a) cannot show learning; a repeated batch
    can. ``keep_params``: also return (b)'s final parameters as one flat
    tensor on the host. ``watch`` maps a step of (b) to ``fn(trainer,
    state)``, called just before it, which returns ``after(state)``,
    called just after it, which returns findings for the run's line."""
    import dataclasses
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)

    def build():
        trainer, cfg = train_mod.build(args)
        if overlap == "staged":
            return trainer, cfg
        cfg = cfg.replace(gradientflow=dataclasses.replace(
            cfg.gradientflow, overlap=overlap))
        return Trainer(cfg, device=args.device), cfg

    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    if overlap == "staged":
        trainer, losses, seconds, run = train_mod.train(args)
        clear_checkpoints()
        check(run["restarts"] == 0 and run["preempted"] is None,
              f"{label}: the CLI's supervisor {run}")
    else:
        trainer, cfg = build()
        losses, seconds = stream_steps(torch, trainer, cfg, args.seed, steps)
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    want = expected_counts(trainer, steps)
    check(counts == want, f"{label}: dispatch counts {counts}, expected "
          f"{want}")
    stages = [trainer.gf.stage_for_step(s) for s in range(steps)]
    del trainer
    torch.cuda.empty_cache()

    trainer, cfg = build()
    state = trainer.init_state(args.seed)
    batch = synthetic.SyntheticLM(cfg.model.vocab_size,
                                  seed=args.seed).batch(0, BATCH, SEQ)
    fns = {}
    ops.reset_counts()
    fixed, findings = [], {}
    import torch.distributed as dist
    with CountAllReduce(dist) as collectives:
        for s in range(steps):
            stage = trainer.gf.stage_for_step(s)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            after = watch[s](trainer, state) if s in (watch or {}) else None
            state, metrics = fns[stage.index](state, batch)
            fixed.append(float(metrics["loss"]))
            if after is not None:
                findings.update(after(state))
    fixed_counts = dict(ops.dispatch_counts)
    want_collectives = expected_collectives(trainer, steps)
    check(collectives.calls == want_collectives, f"{label}: "
          f"{collectives.calls} all-reduces, expected {want_collectives}")
    # On the host, so no later run's peak memory holds it.
    final = torch.cat([p.reshape(-1) for p in
                       trainer.pool.flat_leaves(state.params)]).cpu() \
        if keep_params else None
    check(all(bool(torch.isfinite(p).all())
              for p in trainer.pool.flat_leaves(state.params)),
          f"{label}: non-finite parameters")
    residual_abs_max = None
    if trainer.gf.wire_spec is not None:
        residual_abs_max = state.gf.residual.abs().max().item()
        check(math.isfinite(residual_abs_max) and residual_abs_max > 0,
              f"{label}: residual |max| {residual_abs_max}")
    wire_bytes = [trainer.gf.wire_bytes_per_step(st) for st in stages]
    del state, fns, trainer
    torch.cuda.empty_cache()
    print(f"{label}, one batch, repeated: losses {fixed}", flush=True)
    check(fixed_counts == want, f"{label} (repeated batch): dispatch counts "
          f"{fixed_counts}, expected {want}")
    check(all(math.isfinite(x) for x in fixed),
          f"{label}: non-finite loss {fixed}")
    check(fixed[-1] < fixed[0], f"{label}: loss did not fall on one batch: "
          f"{fixed}")
    run = dict(losses=losses, repeated_batch_losses=fixed,
               step_ms=[t * 1e3 for t in seconds],
               stage=[s.index for s in stages],
               num_selected=[s.num_selected for s in stages],
               peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
               collectives=collectives.calls, wire_bytes_per_step=wire_bytes,
               wire_format=args.wire_format,
               residual_abs_max=residual_abs_max, **findings,
               optimizer=args.optimizer, lr=args.lr, overlap=overlap)
    return (run, final) if keep_params else run


# -- the low-bit wires -------------------------------------------------------

# Analytic wire bytes a step (GradientFlow.wire_bytes_per_step): lazy on
# int8 (the padded pool's 1-byte words and the f32 census) against bf16,
# and CSC's steady k = 616 on int8 (its norm census carries the scales).
WIRE_LAZY_BYTES = {"int8": 134_561_832, "native": 269_030_016}
WIRE_CSC_K616_BYTES = 20_201_512


def watch_error_feedback(torch, wire):
    """(l)'s error-feedback identity on one step, on the device: the packed
    pool ``g`` and the residual before the step, and the words and scales
    of its quantize, are kept; then ``dequant(q) + residual_new`` must
    equal ``g + residual_old`` to f32 rounding: |difference| <= 2^-23 (|g
    + residual_old| + |residual_new|) at every element."""

    def before(trainer, state):
        kept = {"r_old": state.gf.residual.clone()}
        pack_into, quantize = trainer.pool.pack_into, wire.quantize_pool

        def keep_pack(*args, **kwargs):
            out = pack_into(*args, **kwargs)
            kept["g"] = out[0].clone()
            return out

        def keep_quantize(g, scales, **kwargs):
            q, err = quantize(g, scales, **kwargs)
            kept["q"], kept["scales"] = q.clone(), scales.clone()
            return q, err

        trainer.pool.pack_into, wire.quantize_pool = keep_pack, keep_quantize

        def after(state):
            del trainer.pool.pack_into  # the class's method again
            wire.quantize_pool = quantize
            send = kept.pop("g").add_(kept.pop("r_old"))
            r_new = state.gf.residual
            diff = wire.dequantize_pool(kept.pop("q"), kept["scales"], CHUNK)
            diff.add_(r_new).sub_(send).abs_()
            bound = send.abs_().add_(r_new.abs()).mul_(2.0 ** -23)
            excess = diff.sub(bound).max().item()
            found = dict(ef_identity_max_abs_diff=diff.max().item(),
                         ef_identity_r_new_abs_max=r_new.abs().max().item())
            del send, diff, bound
            torch.cuda.empty_cache()
            check(excess <= 0, f"(l) error feedback: dequant(q) + r_new != "
                  f"g + r_old beyond f32 rounding ({found})")
            return found

        return after

    return before


def watch_residual_at_selection(torch, csc):
    """(m) on a steady step (k = 616): the chunks whose residual moved are
    exactly the selected ones (from the chunk norms before the step)."""

    def before(trainer, state):
        k = trainer.gf.stage_for_step(state.step).num_selected
        sel, _ = csc.select_chunks(state.gf.chunk_norms, k)
        r_old = state.gf.residual.clone()

        def after(state):
            moved = (state.gf.residual != r_old).view(-1, CHUNK).any(1)
            moved = moved.nonzero()[:, 0]
            same = torch.equal(moved, sel)
            check(k == CSC_KS[0] and same, f"(m) the residual moved at "
                  f"{moved.numel()} chunks, {k} selected, equal: {same}")
            return dict(residual_moved_chunks=moved.numel(),
                        residual_moved_only_at_selection=same)

        return after

    return before


def quantized_ring_phase(torch, kring, wire, dev, rate):
    """The ring on the words the low-bit wires give it: N = 2, 4, 8 ranks
    in this process, each quantizing its own gradients (one θ bucket of
    normal values, rank r's times r + 1) with the scales of their summed
    census (``wire.scales_from_census``, ``wire.quantize_pool``). int8:
    every rank gets the flat integer sum bit for bit (the grid is exact).
    fp8-e4m3: the dequantized sum within the JAX package's gate (448 x the
    largest scale x 2^-4) of the dequantized f32 sum of the same words,
    and no NaN code (0x7F or 0xFF) in any word, sent or summed."""
    gen = torch.Generator(device=dev).manual_seed(8)
    size = BUCKET_ELEMS
    out = {}
    for n in RING_NS:
        ws = kring.RingWorkspace.in_process(n, dev)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        gs = [torch.randn(size, generator=gen, device=dev) * (r + 1)
              for r in range(n)]
        census = sum(wire.chunk_l1(g, CHUNK) for g in gs)
        for fmt in ("int8", "fp8_e4m3"):
            spec = wire.resolve(fmt)
            sc = wire.scales_from_census(census, chunk_elems=CHUNK,
                                         num_shards=n, spec=spec)
            qs = [wire.quantize_pool(g, sc, chunk_elems=CHUNK, spec=spec,
                                     num_shards=n)[0] for g in gs]
            exact = torch.stack([q.float() for q in qs]).sum(0)
            got = kring.launch_ranks(qs, ws, streams=streams)
            torch.cuda.synchronize()
            check(all(bits_equal(torch, g, got[0]) for g in got),
                  f"quantized ring N={n} {fmt}: ranks differ")
            nan_codes = 0
            if fmt == "int8":
                err = (got[0].float() - exact).abs().max().item()
                check(exact.abs().max().item() <= 127 and torch.equal(
                    got[0].to(torch.int32), exact.to(torch.int32)),
                    f"quantized ring N={n} int8 != the flat sum (max abs "
                    f"diff {err})")
                gate = 0.0
            else:
                nan_codes = sum(int(((x.view(torch.uint8) & 0x7F) == 0x7F)
                                    .sum()) for x in qs + got)
                err = (wire.dequantize_pool(got[0], sc, CHUNK)
                       - wire.dequantize_pool(exact, sc, CHUNK)
                       ).abs().max().item()
                gate = 448.0 * sc.max().item() * 2.0 ** -4
                check(nan_codes == 0 and err <= gate,
                      f"quantized ring N={n} fp8: {nan_codes} NaN codes, "
                      f"max abs err {err} against the gate {gate}")
            nbytes = n * kring.bound_bytes(size, n, spec.dtype, spec.dtype)
            b_ms, b_by = bound_ms(nbytes, n * (n - 1) * -(-size // n), rate)
            out[f"N={n} {fmt}"] = dict(
                ms=time_ms(torch, lambda: kring.launch_ranks(
                    qs, ws, outs=got, streams=streams)),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, gate=gate,
                nan_codes=nan_codes, rank_clip=wire.rank_clip(spec, n),
                elems=size)
            del qs, exact, got
        del ws, gs, census
        torch.cuda.empty_cache()
    return out


# -- the numeric guard -------------------------------------------------------

GUARD_WIDTH = 4096  # pool elements a fault covers
# (step, kind, pool offset, width). (g): three buckets apart, 8 steps.
GUARD_LAZY_FAULTS = ((2, "nan", 1_000_000, GUARD_WIDTH),
                     (4, "overflow", 60_000_000, GUARD_WIDTH),
                     (6, "bitflip", 120_000_000, GUARD_WIDTH))
GUARD_LAZY_STEPS = 8
# (h): the dense warm-up step and a steady sparse step (k = 616). CSC
# unscales before its census, so the overflow limit (2^-9 of the wire's
# max, ~2^119) meets the injected 2^120 divided by the scale (2^14 by
# step 5): 4096 such words sum to 2^118 and pass as legitimate, as in
# the JAX package. The overflow covers a whole chunk (2^121) to trip.
GUARD_CSC_FAULTS = ((0, "nan", 1_000_000, GUARD_WIDTH),
                    (5, "overflow", 1831 * CHUNK, CHUNK))
# (i): LARS lazy monolithic, as (e)'s monolithic run, 6 steps.
GUARD_MONO_FAULTS = ((2, "nan", 1_000_000, GUARD_WIDTH),
                     (4, "overflow", 60_000_000, GUARD_WIDTH))


def fault_events(faults):
    from repro_torch.runtime.faults import FaultEvent
    return [FaultEvent(step=st, kind=kind, offset=off, width=width)
            for st, kind, off, width in faults]


def probing_hook(torch, events, probe):
    """``runtime.faults.make_hook(events)``; for a bitflip event it also
    counts, on the device, the words inside the detectable envelope
    [2^-8, 2) before the flip and the words at 2^119 or more (or Inf)
    after it: that guards the check (a flip of words outside the envelope
    can shrink them), not the path."""
    from repro_torch.runtime.faults import make_hook
    hook = make_hook(events)
    flips = {ev.step: ev for ev in events if ev.kind == "bitflip"}

    def probed(gpool, step):
        ev = flips.get(step)
        if ev is None:
            return hook(gpool, step)
        seg = gpool[ev.offset:ev.offset + ev.width]
        a = seg.float().abs()
        probe["in_envelope"] = ((a >= 2.0 ** -8) & (a < 2.0)).sum()
        out = hook(gpool, step)
        a = seg.float().abs()
        probe["flipped_to_2^119_or_more"] = (a >= 2.0 ** 119).sum()
        return out

    return probed


def state_tensors(trainer, state):
    """Clones of the parameters (one flat tensor), the optimizer state and
    the GradientFlow state (CSC's hg and chunk norms, the low-bit wires'
    residual)."""
    import torch
    flat = torch.cat([p.reshape(-1) for p in
                      trainer.pool.flat_leaves(state.params)])
    return [flat] + [x.clone() for x in tuple(state.opt) + tuple(state.gf)
                     if x.numel()]


def guarded_run(torch, ops, train_mod, label, argv, steps, faults,
                overlap="staged", steady_from=1):
    """``steps`` guarded steps (``GuardConfig()``: scale 2^15) on the
    synthetic stream with ``faults`` injected by the fault hook, built as
    the CLI builds ``argv``. Exactly the faulted steps must trip; each
    trip must leave parameters, optimizer state and CSC's state
    bit-identical (clones taken before the step, compared on the device);
    the scale halves at each trip; clean losses are finite; the dispatch
    counts equal the step plans' (a tripped step still launches its
    predicated updates). ``steady_step_ms`` is the median of the clean
    steps from ``steady_from`` on."""
    import dataclasses
    from repro_torch.configs.base import GuardConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, overlap=overlap, guard=GuardConfig()))
    trainer = Trainer(cfg, device=args.device)
    events = fault_events(faults)
    at = {ev.step for ev in events}
    probe = {}
    hook = probing_hook(torch, events, probe)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns, losses, step_ms, tripped, scales, skipped, frozen = \
        {}, [], [], [], [], [], []
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    collectives = CountAllReduce(torch.distributed)
    for st in range(steps):
        stage = trainer.gf.stage_for_step(st)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage,
                                                        fault_hook=hook)
        batch = data.batch(st, cfg.global_batch, cfg.seq_len)
        before = state_tensors(trainer, state) if st in at else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives:
            state, metrics = fns[stage.index](state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tripped.append(float(metrics["guard_tripped"]))
        scales.append(float(state.guard.scale))
        skipped.append(int(state.guard.skipped))
        if before is not None:
            # No empty_cache here: the next step would pay cudaMalloc.
            frozen.append(all(bits_equal(torch, a, b) for a, b in
                              zip(before, state_tensors(trainer, state))))
            del before
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()
    probe = {k: int(v) for k, v in probe.items()}
    want_scales, scale = [], 2.0 ** 15
    for st in range(steps):
        scale /= 2 if st in at else 1
        want_scales.append(scale)
    print(f"{label}: tripped {tripped}, scale {scales}, losses {losses}",
          flush=True)
    check(tripped == [float(st in at) for st in range(steps)],
          f"{label}: tripped at {tripped}, faults at {sorted(at)}")
    check(len(frozen) == len(at) and all(frozen),
          f"{label}: a tripped step changed the state ({frozen})")
    check(scales == want_scales, f"{label}: scales {scales}")
    check(skipped[-1] == len(at), f"{label}: skipped {skipped}")
    check(all(math.isfinite(x) for st, x in enumerate(losses)
              if st not in at), f"{label}: non-finite clean loss {losses}")
    want = expected_counts(trainer, steps)
    check(counts == want, f"{label}: dispatch counts {counts}, expected "
          f"{want}")
    want_collectives = expected_collectives(trainer, steps)
    check(collectives.calls == want_collectives, f"{label}: "
          f"{collectives.calls} all-reduces, expected {want_collectives}")
    if any(ev.kind == "bitflip" for ev in events):
        check(probe.get("in_envelope", 0) >= 1
              and probe.get("flipped_to_2^119_or_more", 0) >= 1,
              f"{label}: bit flip probe {probe}")
    stages = [trainer.gf.stage_for_step(st) for st in range(steps)]
    del state, fns, trainer
    torch.cuda.empty_cache()
    clean = [step_ms[st] for st in range(steady_from, steps) if st not in at]
    return dict(losses=losses, step_ms=step_ms, tripped=tripped,
                scale=scales, skipped=skipped, trips_bit_identical=frozen,
                faults=[list(f) for f in faults],
                bitflip_probe=probe, stage=[x.index for x in stages],
                num_selected=[x.num_selected for x in stages],
                peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
                collectives=collectives.calls, wire_format=args.wire_format,
                optimizer=args.optimizer, lr=args.lr, overlap=overlap,
                first_step_ms=step_ms[0],
                steady_step_ms=statistics.median(clean),
                tripped_step_ms=[step_ms[st] for st in sorted(at)],
                tokens_per_s=BATCH * SEQ / (statistics.median(clean) / 1e3))


def neutrality_run(torch, ops, train_mod, synthetic, argv, steps):
    """(j): ``steps`` lazy steps on one repeated batch from one seed,
    unguarded, under ``GuardConfig(init_scale=1.0)`` (no fault), and
    unguarded again, each step timed and each run's peak memory read.
    The guarded run must give the unguarded losses and final parameters
    bit for bit; if the two unguarded runs differ from each other, the
    guarded one must stay within their spread."""
    import dataclasses
    from repro_torch.configs.base import GuardConfig
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg0 = train_mod.build(args)
    out = []
    # Unguarded, guarded, unguarded: the two guard-free runs bracket the
    # guarded one, so the step times compare in turns too.
    for guard in (None, GuardConfig(init_scale=1.0), None):
        cfg = cfg0.replace(gradientflow=dataclasses.replace(
            cfg0.gradientflow, guard=guard))
        trainer = Trainer(cfg, device=args.device)
        state = trainer.init_state(args.seed)
        batch = synthetic.SyntheticLM(cfg.model.vocab_size,
                                      seed=args.seed).batch(0, BATCH, SEQ)
        step = trainer.build_train_step()
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # The final parameters on the host, so no run's peak holds them.
        out.append((losses, state_tensors(trainer, state)[0].cpu(),
                    dict(ops.dispatch_counts),
                    [float(x) for x in state.guard] if guard else None,
                    step_ms, peak))
        del state, trainer
        torch.cuda.empty_cache()
    (la, pa, _, _, ma, peak_a), (lg, pg, counts, scaler, mg, peak_g), \
        (lb, pb, _, _, mb, peak_b) = out
    spread = (pa - pb).abs().max().item()
    diff = (pg - pa).abs().max().item()
    loss_spread = max(abs(x - y) for x, y in zip(la, lb))
    loss_diff = max(abs(x - y) for x, y in zip(lg, la))
    same = la == lb and bits_equal(torch, pa, pb)
    print(f"(j) neutrality: unguarded runs the same bits: {same}; guarded "
          f"vs unguarded: largest parameter difference {diff}, loss "
          f"difference {loss_diff}", flush=True)
    if same:
        check(lg == la and bits_equal(torch, pg, pa),
              f"(j) init_scale=1.0 guarded != unguarded: losses {lg} vs "
              f"{la}, largest parameter difference {diff}")
    else:
        check(diff <= spread and loss_diff <= loss_spread,
              f"(j) guarded outside the unguarded spread: {diff} > "
              f"{spread} or {loss_diff} > {loss_spread}")
    check(scaler == [1.0, float(steps), 0.0], f"(j) scaler {scaler}")
    return dict(losses=lg, unguarded_losses=[la, lb],
                unguarded_runs_bitwise_equal=same,
                unguarded_max_param_spread=spread,
                guarded_max_param_diff=diff, loss_diff=loss_diff,
                dispatch_counts=counts, scaler_after=scaler,
                step_ms_unguarded_guarded_unguarded=[ma, mg, mb],
                steady_step_ms_unguarded_guarded_unguarded=[
                    statistics.median(m[1:]) for m in (ma, mg, mb)],
                peak_mem_gib_unguarded_guarded_unguarded=[peak_a, peak_g,
                                                          peak_b])


# -- the window as a CUDA graph, and the cross-step pipeline -----------------

WINDOW_K = 8       # (q), (r), (t): steps a window
WINDOW_TIMED = 3   # replayed windows timed after the first
PIPELINE_TAIL = 2  # (r), (t), (u): deferred buckets
# (s): CSC through the CLI at K = 4. The warm-up stages (first steps 0,
# 2, 4, 6, 8 at --csc-warmup 8) snap to 0, 0, 4, 8, 8: stage 1 (k =
# 3233) and stage 2 (k = 2361) run 4 steps each, the steady stage 4
# (k = 616) 16, four windows (the last three replays, timed); the dense
# stage 0 and stage 3 are shadowed.
CSC_WINDOW_K, CSC_WINDOW_WARMUP, CSC_WINDOW_STEPS = 4, 8, 24
CSC_WINDOW_STAGES = [1] * 4 + [2] * 4 + [4] * 16
CSC_WINDOW_K_SELECTED = [3233] * 4 + [2361] * 4 + [616] * 16
# (u): the two-process ring window.
RING_WINDOW_K = 3


class CountSyncs:
    """Counts the synchronizing CUDA calls PyTorch warns about
    (``torch.cuda.set_sync_debug_mode``) while entered."""

    def __init__(self, torch):
        self.torch, self.calls = torch, 0

    def __enter__(self):
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.calls = sum("synchroniz" in str(w.message) for w in self._log)


def graph_pool_bytes(torch) -> dict:
    """Reserved bytes of each CUDA graph memory pool alive (the
    allocator's segments outside the default pool)."""
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        if pid != (0, 0):
            pools[str(pid)] = pools.get(str(pid), 0) + seg["total_size"]
    return pools


class MemoryLog(list):
    """The CLI's window record (``train(record=...)``), each entry given
    the graph pools alive and the peak reserved memory at its window's
    end."""

    def __init__(self, torch):
        super().__init__()
        self.torch = torch

    def append(self, item):
        item["graph_pool_bytes"] = graph_pool_bytes(self.torch)
        item["max_reserved_bytes"] = self.torch.cuda.max_memory_reserved()
        super().append(item)


def flat_state(torch, trainer, state):
    """The parameters and the momentum as one flat host tensor."""
    return torch.cat([p.reshape(-1) for p in
                      trainer.pool.flat_leaves(state.params)]
                     + [state.opt.momentum]).cpu()


def state_bytes(torch, trainer) -> int:
    """Bytes of a TrainState's tensors: the f32 parameters, the momentum,
    the staging pool, CSC's hg and chunk norms."""
    n = trainer.pool.size
    staging = torch.empty((), dtype=trainer._pack_dtype).element_size()
    out = 4 * trainer.pool.unpadded_size + 4 * n + staging * n
    if trainer.gf_cfg.csc_enabled:
        out += 4 * n + 4 * trainer.gf.num_chunks
    return out


def window_counts(plan, steps):
    """The launches a capture of ``steps`` momentum-SGD step bodies under
    ``plan`` makes: 2 packs a step and an update a span, CSC's census a
    step and its gather a sparse step; with a deferred tail, the tail
    spans' updates at each step's start and at the flush instead, each
    with a pack of its span's masters."""
    tail = plan.pipeline_tail
    want = {"pool_pack.kernel": 2 * steps + tail * (steps + 1),
            "pool_unpack_update.kernel": (len(plan.update_spans) - tail)
            * steps + tail * (steps + 1)}
    if plan.mode == "csc":
        want["chunk_l1norm.kernel"] = steps
        if not plan.warmup:
            want["csc_compact.kernel"] = steps
    return want


# The repo's kernels, by the names of their CUDA functions.
POOL_KERNELS = ("pool_pack_kernel", "pool_unpack_update_kernel",
                "chunk_l1norm", "csc_compact", "fused_update_kernel",
                "ring_kernel")


def device_profile(torch, fn, steps):
    """Run ``fn`` (``steps`` train steps, ending in a host read) under
    ``torch.profiler`` and split the device's time from the trace's
    kernels: busy (the union of the kernels' intervals) against the wall
    time on the host clock, so the idle share, and per step the kernel
    count and the time of the repo's pool kernels, of the GEMMs and of
    the rest. Times include the profiler's own overhead."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "kernel")
    check(len(kernels) > 0, "the profiler saw no device kernel")
    busy, end = 0.0, None
    for a, b, _ in kernels:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    split = {"pool_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for a, b, name in kernels:
        low = name.lower()
        key = "pool_kernels" if any(k in name for k in POOL_KERNELS) else \
            "gemm" if any(k in low for k in ("gemm", "nvjet", "cutlass",
                                             "xmma")) else "other"
        split[key] += (b - a) / 1e3 / steps
    return dict(wall_ms=wall, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / wall,
                kernels_per_step=len(kernels) / steps,
                kernel_ms_per_step=split, steps=steps,
                note="torch.profiler (CUPTI); its overhead included")


def stacked(torch, batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def window_trainer(train_mod, argv, tail, guard=None):
    import dataclasses
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, pipeline_tail_buckets=tail, guard=guard))
    return args, cfg, Trainer(cfg, device=args.device)


def window_run(torch, dist, ops, train_mod, label, argv, tail, twin=None):
    """(q)/(r): a lazy window of WINDOW_K steps as a CUDA graph on the
    synthetic stream, in the NCCL group: the first window (capture, then
    replay) against ``twin`` (None: WINDOW_K eager steps of the CLI's
    loop from the same seed, timed; else (q)'s result), the same bits;
    then WINDOW_TIMED replayed windows timed, one profiled
    (``device_profile``) and one with its synchronizing calls counted
    (eager: two more steps' each). The
    capture's launches against the plan's, the all-reduces of the first
    window (the warm-up body and the capture) and of the replayed ones,
    the peak memory. Returns (run, twin)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import is_flushed

    args, cfg, trainer = window_trainer(train_mod, argv, tail)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    batches = [data.batch(s, BATCH, SEQ)
               for s in range(WINDOW_K * (1 + WINDOW_TIMED))]
    out = {}
    if twin is None:
        state = trainer.init_state(args.seed)
        step = trainer.build_train_step()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, enqueue_ms = [], [], []
        for s in range(WINDOW_K):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[s])
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        twin = dict(losses=losses, final=flat_state(torch, trainer, state))
        with CountSyncs(torch) as syncs:
            for s in range(WINDOW_K, WINDOW_K + 2):
                state, m = step(state, batches[s])
                float(m["loss"])

        def two_steps():
            nonlocal state
            for s in range(WINDOW_K + 2, WINDOW_K + 4):
                state, m = step(state, batches[s])
                float(m["loss"])

        out["eager_profile"] = device_profile(torch, two_steps, 2)
        e = statistics.median(step_ms[1:])
        # enqueue: the host's time to return from a step, before the read
        # of its loss waits for the device.
        out.update(eager_step_ms=step_ms, eager_steady_step_ms=e,
                   eager_enqueue_ms=statistics.median(enqueue_ms[1:]),
                   eager_peak_mem_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30, eager_syncs_per_step=syncs.calls / 2)
        del state, step
    plan = trainer.engine.plan_for()
    check(plan.pipeline_tail == tail
          and (trainer._pipeline_plan() is not None) == bool(tail),
          f"{label}: plan tail {plan.pipeline_tail}, expected {tail}")
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    ops.reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CountAllReduce(dist) as first:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, batches[:WINDOW_K]))
        losses = m["loss"].tolist()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved()
    pools = graph_pool_bytes(torch)
    final = flat_state(torch, trainer, state)
    win_ms, win_enqueue_ms = [], []
    with CountAllReduce(dist) as replayed:
        for w in range(1, 1 + WINDOW_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = window(state, stacked(
                torch, batches[w * WINDOW_K:(w + 1) * WINDOW_K]))
            win_enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            m["loss"].tolist()
            torch.cuda.synchronize()
            win_ms.append((time.perf_counter() - t0) * 1e3)
    def one_window():
        nonlocal state
        state, m = window(state, stacked(torch, batches[:WINDOW_K]))
        m["loss"].tolist()

    out["profile"] = device_profile(torch, one_window, WINDOW_K)
    with CountSyncs(torch) as syncs:
        one_window()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats, counts = dict(window.stats), dict(ops.dispatch_counts)
    flushed, sbytes = is_flushed(state), state_bytes(torch, trainer)
    window.release()
    del state, window, trainer
    torch.cuda.empty_cache()
    print(f"{label}: losses {losses}; window ms {win_ms}", flush=True)
    same = losses == twin["losses"] and bits_equal(torch, final,
                                                   twin["final"])
    check(same, f"{label}: the graphed window != its twin (losses {losses} "
          f"vs {twin['losses']}, largest state difference "
          f"{(final - twin['final']).abs().max().item()})")
    check(flushed, f"{label}: the returned state carries a live lane")
    check(len(pools) == 1, f"{label}: graph pools alive after the capture "
          f"{pools} (an earlier window's not freed)")
    want = window_counts(plan, WINDOW_K)
    check(stats["capture_counts"] == want, f"{label}: the capture launched "
          f"{stats['capture_counts']}, the plan says {want}")
    check(stats["captures"] == 1 and stats["replays"] == 3 + WINDOW_TIMED,
          f"{label}: {stats['captures']} captures, {stats['replays']} "
          f"replays")
    check(first.calls == (WINDOW_K + 1) * len(plan.tasks)
          and replayed.calls == 0,
          f"{label}: all-reduce calls {first.calls} in the first window "
          f"(warm-up body + capture), {replayed.calls} in the replayed ones")
    check(syncs.calls == 1, f"{label}: {syncs.calls} synchronizing calls "
          f"in a window and its read")
    step_ms = statistics.median(win_ms) / WINDOW_K
    out.update(losses=losses, window_ms=win_ms, steady_step_ms=step_ms,
               window_enqueue_ms=win_enqueue_ms,
               tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
               first_window_s=first_s, warmup_s=stats["warmup_s"],
               capture_s=stats["capture_s"],
               capture_counts=stats["capture_counts"],
               expected_capture_counts=want,
               warmup_counts=stats["warmup_counts"],
               dispatch_counts=counts, replays=stats["replays"],
               all_reduce_calls_first_window=first.calls,
               all_reduce_calls_replayed_windows=replayed.calls,
               syncs_per_window=syncs.calls, peak_mem_gib=peak,
               reserved_after_capture_gib=reserved / 2 ** 30,
               graph_pool_gib={k: v / 2 ** 30 for k, v in pools.items()},
               state_gib=sbytes / 2 ** 30, pipeline_tail=tail,
               window_steps=WINDOW_K, same_bits_as_twin=same,
               twin="eager steps" if "eager_step_ms" in out
               else "(q), the unpipelined window")
    if "eager_steady_step_ms" in out:
        e = out["eager_steady_step_ms"]
        out["steady_delta_pct"] = 100.0 * (step_ms - e) / e
    return out, twin


def csc_window_run(torch, ops, train_mod, label, argv):
    """(s): CSC through the CLI at --window-steps 4 over the snapped
    warm-up stages, one graph a stage, each freed when its stage ends;
    then the same steps eagerly under the same snapped schedule: the same
    losses bit for bit. At each window's end at most one graph pool is
    alive; the peak reserved memory stays under one stage graph's pool
    plus the state, plus the warm-up's scratch clone of the state."""
    from repro_torch.core.schedule import (snap_stages_to_window, stage_at,
                                           stage_first_steps)
    from repro_torch.data.synthetic import SyntheticLM

    args = train_mod.parse_args(argv)
    record = MemoryLog(torch)
    ops.reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, losses, _, run = train_mod.train(args, record=record)
    clear_checkpoints()
    check(run["restarts"] == 0 and run["preempted"] is None,
          f"{label}: the CLI's supervisor {run}")
    peak_reserved = torch.cuda.max_memory_reserved()
    sbytes = state_bytes(torch, trainer)
    counts = dict(ops.dispatch_counts)
    stages = snap_stages_to_window(trainer.gf.stages, CSC_WINDOW_K)
    firsts = stage_first_steps(stages)
    plans = [trainer.gf.plan(stage_at(stages, r["start"], firsts))
             for r in record]
    del trainer
    torch.cuda.empty_cache()
    # The eager twin under the same snapped schedule.
    trainer, cfg = train_mod.build(args)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns, eager, ran, eager_ms = {}, [], [], []
    for s in range(CSC_WINDOW_STEPS):
        stage = stage_at(stages, s, firsts)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        # Timed as the CLI times a step: the batch made, the card idle.
        batch = data.batch(s, BATCH, SEQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fns[stage.index](state, batch)
        eager.append(float(m["loss"]))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        ran.append((stage.index, stage.num_selected))
    del state, fns, trainer
    torch.cuda.empty_cache()
    print(f"{label}: losses {losses}; eager {eager}", flush=True)
    check(ran == list(zip(CSC_WINDOW_STAGES, CSC_WINDOW_K_SELECTED)),
          f"{label}: stages (index, k) {ran}")
    check([r["stage"] for r in record]
          == CSC_WINDOW_STAGES[::CSC_WINDOW_K],
          f"{label}: windows' stages {[r['stage'] for r in record]}")
    check(losses == eager, f"{label}: graphed losses {losses} != eager "
          f"{eager} under the same snapped stages")
    pools = [r["graph_pool_bytes"] for r in record]
    check(all(len(p) == 1 for p in pools)
          and len({k for p in pools for k in p}) == len(set(
              CSC_WINDOW_STAGES)),
          f"{label}: graph pools alive at the windows' ends {pools}")
    for i, (r, plan) in enumerate(zip(record, plans)):
        st = r["stats"]
        want = window_counts(plan, CSC_WINDOW_K)
        replays = sum(x["stage"] == r["stage"] for x in record[:i + 1])
        check(st["captures"] == 1 and st["replays"] == replays
              and st["capture_counts"] == want,
              f"{label}: window at {r['start']}: {st}, expected capture "
              f"counts {want}, {replays} replays")
    largest = max(v for p in pools for v in p.values())
    bound = largest + 2 * sbytes + 2 ** 29
    check(peak_reserved <= bound, f"{label}: peak reserved "
          f"{peak_reserved / 2 ** 30:.3f} GiB above one graph pool "
          f"({largest / 2 ** 30:.3f}) + the state and its warm-up clone "
          f"(2 x {sbytes / 2 ** 30:.3f}) + 0.5 GiB")
    # Each stage's first window pays its warm-up and capture; the steady
    # stage's later windows are replays alone, timed against the eager
    # twin's steady steps after the stage's first.
    steady = CSC_WINDOW_STAGES[-1]
    replay_ms = [r["seconds"] * 1e3 / CSC_WINDOW_K for r in record
                 if r["stage"] == steady][1:]
    first = CSC_WINDOW_STAGES.index(steady)
    twin_ms = eager_ms[first + 1:]
    step_ms = statistics.median(replay_ms)
    twin = statistics.median(twin_ms)
    return dict(losses=losses, eager_losses=eager,
                stages=[r["stage"] for r in record],
                num_selected=CSC_WINDOW_K_SELECTED,
                window_ms=[r["seconds"] * 1e3 for r in record],
                steady_step_ms=step_ms, steady_replay_step_ms=replay_ms,
                eager_steady_step_ms=twin, eager_step_ms=eager_ms,
                steady_delta_pct=100.0 * (step_ms / twin - 1.0),
                capture_counts=[r["stats"]["capture_counts"]
                                for r in record],
                warmup_s=[r["stats"]["warmup_s"] for r in record],
                capture_s=[r["stats"]["capture_s"] for r in record],
                graph_pool_gib=[{k: v / 2 ** 30 for k, v in p.items()}
                                for p in pools],
                reserved_gib_at_window_ends=[r["reserved_bytes"] / 2 ** 30
                                             for r in record],
                peak_reserved_gib=peak_reserved / 2 ** 30,
                state_gib=sbytes / 2 ** 30, dispatch_counts=counts,
                window_steps=CSC_WINDOW_K, same_bits_as_eager=True)


def guarded_window_run(torch, ops, train_mod, label, argv, tail, faults,
                       twin_losses, twin=None):
    """(t): a guarded lazy window of WINDOW_K steps as a CUDA graph with
    ``faults`` fired by the device-step hook inside it. The hook also
    records, inside the graph, a digest of the parameters and momentum
    (each tensor's int32 words summed) as each step's update starts:
    a tripped step t leaves digest t+1 equal to digest t (and a clean
    one changes it). Exactly the faulted steps trip; the losses equal
    ``twin_losses`` (the eager guarded run (g)); with ``twin`` (the
    unpipelined window's) the losses and the state the same bits."""
    from repro_torch.configs.base import GuardConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import is_flushed
    from repro_torch.runtime.faults import make_hook

    args, cfg, trainer = window_trainer(train_mod, argv, tail,
                                        guard=GuardConfig())
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    hook = make_hook(fault_events(faults))
    live = trainer.pool.flat_leaves(state.params) + [state.opt.momentum]
    digests = []

    def probed(gpool, step):
        digests.append(torch.stack([x.view(torch.int32).sum(
            dtype=torch.int64) for x in live]))
        return hook(gpool, step)

    window = trainer.build_train_window(WINDOW_K, fault_hook=probed)
    ops.reset_counts()
    state, m = window(state, stacked(torch, [data.batch(s, BATCH, SEQ)
                                             for s in range(WINDOW_K)]))
    losses, tripped = m["loss"].tolist(), m["guard_tripped"].tolist()
    after = torch.stack([x.view(torch.int32).sum(dtype=torch.int64)
                         for x in live])
    d = torch.stack(digests[-WINDOW_K:] + [after]).cpu()
    at = {f[0] for f in faults}
    frozen = [bool(torch.equal(d[t + 1], d[t])) for t in sorted(at)]
    moved = [not torch.equal(d[t + 1], d[t]) for t in range(WINDOW_K)
             if t not in at]
    scale, skipped = float(state.guard.scale), int(state.guard.skipped)
    final = flat_state(torch, trainer, state)
    stats, flushed = dict(window.stats), is_flushed(state)
    counts = dict(ops.dispatch_counts)
    window.release()
    del state, window, trainer, live, digests
    torch.cuda.empty_cache()
    print(f"{label}: tripped {tripped}, losses {losses}", flush=True)
    check(tripped == [float(t in at) for t in range(WINDOW_K)],
          f"{label}: tripped {tripped}, faults at {sorted(at)}")
    check(all(frozen) and all(moved), f"{label}: a tripped step moved the "
          f"state ({frozen}) or a clean one did not ({moved})")
    check(scale == 2.0 ** 15 / 2 ** len(at) and skipped == len(at),
          f"{label}: scale {scale}, skipped {skipped}")
    check(flushed, f"{label}: the returned state carries a live lane")
    check(losses == twin_losses, f"{label}: losses {losses} != the eager "
          f"guarded run's {twin_losses}")
    if twin is not None:
        check(losses == twin["losses"] and bits_equal(torch, final,
                                                      twin["final"]),
              f"{label}: the pipelined guarded window != the unpipelined")
    return dict(losses=losses, tripped=tripped, faults=[list(f) for f in
                                                        faults],
                trips_bit_identical=frozen, clean_steps_moved=moved,
                scale_after=scale, skipped=skipped,
                capture_counts=stats["capture_counts"],
                dispatch_counts=counts, replays=stats["replays"],
                pipeline_tail=tail, window_steps=WINDOW_K), \
        dict(losses=losses, final=final)


def guard_lane_phase(torch, dev):
    """``GuardLane`` on the card, lazy and CSC: the windowed lane
    (window=4) gives the per-step records."""
    from repro_torch.runtime.faults import FaultEvent, GuardLane, truth_table

    faults = [FaultEvent(step=2, kind="nan", offset=8, width=4),
              FaultEvent(step=5, kind="overflow", offset=40, width=4),
              FaultEvent(step=6, kind="bitflip", offset=100, width=6)]
    out = {}
    for mode in ("lazy", "csc"):
        per_step = GuardLane(mode=mode, device=dev).run(9, faults)
        windowed = GuardLane(mode=mode, device=dev).run(9, faults, window=4)
        check(windowed == per_step, f"GuardLane {mode}: window=4 records "
              f"{windowed} != per-step {per_step}")
        table = truth_table(windowed)
        check(table["false_trips"] == 0 and all(
            row["caught"] == row["injected"]
            for row in table["classes"].values()),
              f"GuardLane {mode}: {table}")
        out[mode] = table
    return out


# -- checkpoints, restarts, resume, elastic ---------------------------------

# Every checkpoint of this script goes under a temporary directory of its
# own (the CLI's default one too: ``tempfile.tempdir`` and, for the
# processes it starts, TMPDIR point there), emptied after each phase and
# removed at the end.
CKPT_ROOT = None
CKPT_FREE_BYTES = 16 * 2 ** 30  # (w)'s two directories hold ~6.5 GB
# (v): lazy windows of K = 8 under the supervisor, a checkpoint every 8,
# a host fault raised at step 20 inside the window 16-23 after its
# replay ran (the live tensors then hold step 24's values).
SUP_STEPS, SUP_EVERY, SUP_FAULT = 32, 8, 20
# (w): a 24-step CSC run preempted (SIGTERM) after step 16, then a new
# process with the same flags, which resumes at 16.
RESUME_FIRST, RESUME_EVERY = 16, 8
# (x): two ranks over the ring, CSC, 12 steps (the schedule's length), a
# checkpoint at 8; then one rank from 8. The bound on its losses' largest
# relative difference from the two ranks' lies between the sound reading
# and the controls' (NVIDIA H100 80GB HBM3, 700 W: 9.26e-6 sound; the
# restored hg zeroed 5.27e-5, rank 0's row alone 1.65e-5).
ELASTIC_STEPS, ELASTIC_AT, ELASTIC_RTOL = 12, 8, 1.25e-5


def make_ckpt_root() -> None:
    """The script's checkpoint directory, after checking the disk holds
    the largest phase's checkpoints."""
    global CKPT_ROOT
    import shutil
    import tempfile
    parent = tempfile.gettempdir()
    free = shutil.disk_usage(parent).free
    check(free >= CKPT_FREE_BYTES, f"checkpoints: {free / 2 ** 30:.1f} GiB "
          f"free under {parent}, the checkpoint phases need "
          f"{CKPT_FREE_BYTES / 2 ** 30:.0f} GiB")
    CKPT_ROOT = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    tempfile.tempdir = CKPT_ROOT
    os.environ["TMPDIR"] = CKPT_ROOT


def clear_checkpoints() -> None:
    """Remove every checkpoint a phase left (the CLI saves at its end)."""
    import shutil
    if CKPT_ROOT is not None:
        for name in os.listdir(CKPT_ROOT):
            shutil.rmtree(os.path.join(CKPT_ROOT, name), ignore_errors=True)


def remove_ckpt_root() -> None:
    import shutil
    import tempfile
    if CKPT_ROOT is not None:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        tempfile.tempdir = None


def ckpt_dir(name: str) -> str:
    path = os.path.join(CKPT_ROOT, name)
    os.makedirs(path)
    return path


def timed_manager(path):
    """A ``CheckpointManager`` that also times each ``save`` call (its
    blocking part: the snapshot; the final save's write too) and each
    ``restore``."""
    from repro_torch.checkpoint.manager import CheckpointManager

    class Timed(CheckpointManager):
        def __init__(self, directory):
            super().__init__(directory, keep=3)
            self.saves, self.restores = [], []

        def save(self, step, state, blocking=False, logical=False):
            t0 = time.perf_counter()
            super().save(step, state, blocking=blocking, logical=logical)
            self.saves.append(dict(step=int(step), blocking=blocking,
                                   seconds=time.perf_counter() - t0))

        def restore(self, like, step=None, logical=False):
            t0 = time.perf_counter()
            out = super().restore(like, step=step, logical=logical)
            self.restores.append(dict(step=out[0],
                                      seconds=time.perf_counter() - t0))
            return out

    return Timed(path)


def supervisor_run(torch, ops, train_mod, label, argv):
    """(v): lazy windows of WINDOW_K under ``TrainSupervisor.run_windows``
    (a checkpoint every SUP_EVERY steps, batches from a ``DataPipeline``),
    a host fault raised at step SUP_FAULT after the window 16-23 ran:
    one restart, a restore of step 16 into the live tensors, and the
    window's one graph replayed on them. Against an uninterrupted run of
    the same windows from the same seed in this process: every loss of
    the final pass and the final parameters and momentum, bit for bit.
    Times each save's blocking part, the writer thread, the restore, and
    each window, which either overlaps a write in flight or not."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.runtime.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)

    args, cfg, trainer = window_trainer(train_mod, argv, 0)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    batches = [data.batch(s, BATCH, SEQ) for s in range(SUP_STEPS)]
    # The uninterrupted run: no supervisor, no checkpoint.
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    ref_losses, ref_ms = [], []
    for w in range(0, SUP_STEPS, WINDOW_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, batches[w:w + WINDOW_K]))
        ref_losses += m["loss"].tolist()
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    ref_final = flat_state(torch, trainer, state)
    window.release()
    del state, window
    torch.cuda.empty_cache()

    ckpt = timed_manager(ckpt_dir("v"))
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=SUP_EVERY))
    pipe = DataPipeline(data, BATCH, SEQ, prefetch=0)  # as the CLI's
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    losses, windows, restored = {}, [], []
    fired = {"done": False}

    def window_fn(step, length, state):
        bs = [pipe.next_at(step + i) for i in range(length)]
        writing = ckpt.writing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, bs))
        got = m["loss"].tolist()
        torch.cuda.synchronize()
        windows.append(dict(start=step, ms=(time.perf_counter() - t0) * 1e3,
                            write_in_flight=writing))
        if step <= SUP_FAULT < step + length and not fired["done"]:
            fired["done"] = True
            raise RuntimeError(f"host fault at step {SUP_FAULT}")
        losses.update(zip(range(step, step + length), got))
        return state

    def on_restore(step):
        restored.append(step)
        pipe.skip_to(step)

    ops.reset_counts()
    pipe.start(0)
    try:
        state = sup.run_windows(state, 0, SUP_STEPS, window_fn, WINDOW_K,
                                on_restore=on_restore)
    finally:
        pipe.stop()
    final = flat_state(torch, trainer, state)
    stats, counts = dict(window.stats), dict(ops.dispatch_counts)
    plan = trainer.engine.plan_for()
    # The warm-up runs one step body, the capture WINDOW_K; every replay
    # (the restarted window's too) launches nothing from the host.
    want_warmup, want_capture = window_counts(plan, 1), window_counts(
        plan, WINDOW_K)
    steps_on_disk = ckpt.available_steps()
    window.release()
    del state, window, trainer
    torch.cuda.empty_cache()
    got = [losses[s] for s in range(SUP_STEPS)]
    print(f"{label}: losses {got}; saves {ckpt.saves}; writes "
          f"{ckpt.writes}; restores {ckpt.restores}", flush=True)
    check(sup.restarts == 1 and restored == [16], f"{label}: restarts "
          f"{sup.run_stats()}, restored to {restored}")
    check([x["step"] for x in ckpt.saves] == [8, 16, 24, 32]
          and [x["step"] for x in ckpt.writes] == [8, 16, 24, 32],
          f"{label}: saves {ckpt.saves}, writes {ckpt.writes}")
    check(steps_on_disk == [16, 24, 32], f"{label}: on disk "
          f"{steps_on_disk} (keep=3)")
    check(stats["captures"] == 1, f"{label}: {stats['captures']} captures "
          f"(a restore into the live tensors keeps the graph)")
    check(stats["warmup_counts"] == want_warmup
          and stats["capture_counts"] == want_capture
          and counts == {k: want_warmup[k] + want_capture[k]
                         for k in want_capture},
          f"{label}: counts {counts}, warm-up {stats['warmup_counts']}, "
          f"capture {stats['capture_counts']}; the plan says "
          f"{want_warmup} and {want_capture}")
    check(got == ref_losses, f"{label}: final pass losses {got} != the "
          f"uninterrupted run's {ref_losses}")
    check(bits_equal(torch, final, ref_final), f"{label}: the final state "
          f"differs from the uninterrupted run's by "
          f"{(final - ref_final).abs().max().item()}")
    # Replayed windows only (the first captures): with a write in flight,
    # and without (the uninterrupted run's, and the supervised run's
    # window replayed after the restore, which waits for the write).
    over = [w["ms"] / WINDOW_K for w in windows[1:] if w["write_in_flight"]]
    quiet = [w["ms"] / WINDOW_K for w in windows[1:]
             if not w["write_in_flight"]] + [t / WINDOW_K
                                             for t in ref_ms[1:]]
    check(over and quiet, f"{label}: windows {windows}")
    o, q = statistics.median(over), statistics.median(quiet)
    clear_checkpoints()
    return dict(losses=got, windows=windows,
                reference_window_ms=ref_ms,
                step_ms_write_in_flight=over, step_ms_no_write=quiet,
                median_step_ms_write_in_flight=o,
                median_step_ms_no_write=q,
                write_overlap_delta_pct=100.0 * (o / q - 1.0),
                save_blocking_s=ckpt.saves, writer=ckpt.writes,
                bytes_per_checkpoint=[x["bytes"] for x in ckpt.writes],
                restore_s=ckpt.restores, restarts=sup.run_stats(),
                restored_to=restored, steps_on_disk=steps_on_disk,
                window_stats=stats, dispatch_counts=counts,
                expected_capture_counts=want_capture,
                checkpoint_every=SUP_EVERY, fault_step=SUP_FAULT,
                window_steps=WINDOW_K, same_bits_as="an uninterrupted "
                "32-step window run in this process",
                hash_on_writer_thread=True)


class PreemptAfter(list):
    """The CLI's window record (``train(record=...)``) that sends this
    process a SIGTERM, as a scheduler's preemption notice, when the
    window ending at ``step`` has run: the CLI's handler then stops the
    run at that window's edge, with its checkpoint there."""

    def __init__(self, step: int):
        super().__init__()
        self.step = step

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step:
            import signal
            os.kill(os.getpid(), signal.SIGTERM)


def cli_worker(out: str, argv, preempt_at=None) -> None:
    """One CLI run in a process of its own (``--cli-train OUT
    [--preempt-at STEP] -- argv``): ``repro_torch.launch.train.train`` on
    ``argv``, preempted by a SIGTERM after step ``preempt_at`` if given;
    its losses, step seconds, windows and supervisor stats to ``out`` as
    JSON."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    record = [] if preempt_at is None else PreemptAfter(preempt_at)
    ops.reset_counts()
    _, losses, seconds, run = train_mod.train(train_mod.parse_args(argv),
                                              record=record)
    with open(out, "w") as f:
        json.dump(dict(losses=losses, seconds=seconds, run=run,
                       counts=dict(ops.dispatch_counts), windows=[
                           dict(start=r["start"], length=r["length"],
                                stage=r["stage"]) for r in record]), f)


def cli_processes(runs):
    """Run each (out, argv, preempt_at) of ``runs`` as a ``cli_worker``
    process, all at once; their results."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-train", out,
         *([] if at is None else ["--preempt-at", str(at)]), "--", *argv])
        for out, argv, at in runs]
    try:
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("CLI processes did not finish within 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"CLI processes: exit codes {[p.returncode for p in procs]}")
    results = []
    for out, _, _ in runs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def resume_phase(label, csc_argv):
    """(w): CSC through the CLI at --window-steps 4 in new processes, each
    with --steps 24: one is preempted by a SIGTERM after step 16 (its
    checkpoints at 8 and 16), and beside it one runs all 24 steps; then a
    third, launched with the first's flags, resumes its directory at 16
    and runs to 24. Its losses are the uninterrupted run's for steps
    16-23, and its final checkpoint holds the same bits (the SHA-256 of
    every leaf: parameters, momentum, hg, chunk norms). No process
    restarted a window."""
    total = CSC_WINDOW_STEPS
    argv = csc_argv + ["--csc-warmup", str(CSC_WINDOW_WARMUP),
                       "--window-steps", str(CSC_WINDOW_K), "--log-every",
                       "4", "--ckpt-every", str(RESUME_EVERY), "--steps",
                       str(total)]
    part, whole = ckpt_dir("w_part"), ckpt_dir("w_whole")
    outs = [os.path.join(CKPT_ROOT, f"w_{n}.json")
            for n in ("first", "whole", "resumed")]
    t0 = time.perf_counter()
    first, ref = cli_processes([
        (outs[0], argv + ["--ckpt-dir", part], RESUME_FIRST),
        (outs[1], argv + ["--ckpt-dir", whole], None)])
    on_disk = sorted(int(n[5:]) for n in os.listdir(part))
    (resumed,) = cli_processes([(outs[2], argv + ["--ckpt-dir", part],
                                 None)])
    seconds = time.perf_counter() - t0
    got = [m for m in manifest(part, total)["leaves"]]
    want = [m for m in manifest(whole, total)["leaves"]]
    same = {m["name"]: m["sha256"] == w["sha256"]
            for m, w in zip(got, want) if not m.get("scratch")}
    print(f"{label}: resumed losses {resumed['losses']}; uninterrupted "
          f"{ref['losses'][RESUME_FIRST:]}", flush=True)
    runs = [first["run"], ref["run"], resumed["run"]]
    check(all(r["restarts"] == 0 for r in runs)
          and [r["preempted"] for r in runs] == [RESUME_FIRST, None, None],
          f"{label}: the processes' supervisor stats {runs}")
    check(on_disk == [8, 16], f"{label}: the first process left {on_disk}")
    check(resumed["windows"][0]["start"] == RESUME_FIRST, f"{label}: the "
          f"resumed process started at {resumed['windows'][0]}")
    check(first["losses"] == ref["losses"][:RESUME_FIRST], f"{label}: the "
          f"first process's losses differ from the uninterrupted run's")
    check(resumed["losses"] == ref["losses"][RESUME_FIRST:], f"{label}: "
          f"resumed losses {resumed['losses']} != uninterrupted "
          f"{ref['losses'][RESUME_FIRST:]}")
    check([m["name"] for m in got] == [m["name"] for m in want]
          and all(same.values()), f"{label}: final leaves differ: "
          f"{[k for k, v in same.items() if not v]}")
    check({"gf/hg", "gf/chunk_norms", "opt/momentum"} <= set(same),
          f"{label}: leaves {sorted(same)}")
    counts = resumed["counts"]
    check(all(counts.get(f"{k}.kernel", 0) > 0 for k in (
        "pool_pack", "pool_unpack_update", "chunk_l1norm", "csc_compact"))
          and not any(k.endswith(".plain") for k in counts),
          f"{label}: the resumed process's counts {counts}")
    clear_checkpoints()
    return dict(losses=resumed["losses"],
                uninterrupted_losses=ref["losses"],
                first_losses=first["losses"],
                resumed_windows=resumed["windows"],
                resumed_step_ms=[t * 1e3 for t in resumed["seconds"]],
                uninterrupted_step_ms=[t * 1e3 for t in ref["seconds"]],
                first_process_checkpoints=on_disk, dispatch_counts=counts,
                preempted_at=first["run"]["preempted"],
                leaves_same_sha256=same, seconds_all_processes=seconds,
                window_steps=CSC_WINDOW_K, same_bits_as="an uninterrupted "
                "24-step CLI run in another process")


def elastic_phase(torch, ops, train_mod, ring, csc_argv, path):
    """(x), after (c)'s two ranks ran 12 CSC steps over the ring with a
    checkpoint at 8 (``ring``: rank 0's record): one process follows the
    elastic pattern — restore step 8 into a host state of the two-rank
    layout, ``reshard_hg`` to one row, save again at 8 — then a Trainer
    at N = 1 restores in place and trains steps 8-11 on the same global
    batch. The column total of hg as numpy sums it, the live hg the
    re-split row bit for bit, rank 0's parameters and momentum at 8, a
    one-rank plan, the launches its plans say, and losses within
    ELASTIC_RTOL of the two ranks'. Two controls, the restored hg zeroed
    and rank 0's row alone in its place, must exceed that bound."""
    import dataclasses
    import hashlib

    import numpy as np
    from repro_torch.checkpoint import reshard
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(csc_argv + ["--steps", str(ELASTIC_STEPS)])
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, collective_algo="pallas_ring"))
    trainer = Trainer(cfg)
    ckpt = timed_manager(path)
    meta = {m["name"]: m for m in manifest(path, ELASTIC_AT)["leaves"]}
    check(meta["gf/hg"]["shape"] == [2, trainer.pool.size], f"(x): the "
          f"two ranks saved hg of {meta['gf/hg']['shape']}")
    check(reshard.plan([(n, m["shape"]) for n, m in meta.items()], 1) == [],
          "(x): the reshard plan found a problem")
    old = reshard.host_like(trainer.init_state(args.seed), 2)
    _, old = ckpt.restore(old, step=ELASTIC_AT, logical=True)
    t0 = time.perf_counter()
    new = reshard.reshard_state(old, 1)
    reshard_s = time.perf_counter() - t0
    total = old.gf.hg.numpy().sum(axis=0)
    check(np.array_equal(new.gf.hg.numpy()[0], total),
          "(x): the re-split hg's column total differs from numpy's sum")
    ckpt.save(ELASTIC_AT, new, blocking=True, logical=True)
    resplit, row0 = new.gf.hg[0].clone(), old.gf.hg[0].clone()
    del old, new
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns = {}

    def one_rank(hg=None):
        """Step ELASTIC_AT restored into the live one-rank state (``hg``,
        if given, then written over its hg: a control), steps 8-11;
        (losses, digest of the restored parameters and momentum, whether
        the live hg is the re-split row bit for bit)."""
        nonlocal state
        _, state = ckpt.restore(state, step=ELASTIC_AT)
        same_hg = torch.equal(state.gf.hg.cpu(), resplit)
        flat = torch.cat([p.reshape(-1) for p in
                          trainer.pool.flat_leaves(state.params)]
                         + [state.opt.momentum]).cpu()
        digest = hashlib.sha256(flat.numpy().tobytes()).hexdigest()
        del flat
        if hg is not None:
            state.gf.hg.copy_(hg)
        losses = []
        for s in range(ELASTIC_AT, ELASTIC_STEPS):
            stage = trainer.gf.stage_for_step(s)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, m = fns[stage.index](state, data.batch(s, BATCH, SEQ))
            losses.append(float(m["loss"]))
        return losses, digest, same_hg

    two = ring["losses"][ELASTIC_AT:]

    def max_rel(losses):
        return max(abs(a / b - 1.0) for a, b in zip(losses, two))

    ops.reset_counts()
    losses, digest, same_hg = one_rank()
    counts = dict(ops.dispatch_counts)
    key, theta = trainer.gf.plan_cache_key(), trainer.gf.bucket_elems
    want = expected_counts(trainer, ELASTIC_STEPS - ELASTIC_AT, ELASTIC_AT)
    # The controls (launches not counted): what the bound must see.
    controls = {name: max_rel(one_rank(hg)[0]) for name, hg in (
        ("hg_zeroed", torch.zeros_like(resplit)),
        ("rank0_row_alone", row0))}
    del state, fns, trainer
    torch.cuda.empty_cache()
    rel = [abs(a / b - 1.0) for a, b in zip(losses, two)]
    print(f"(x): one rank {losses}; two ranks {two}; relative {rel}; "
          f"controls {controls}", flush=True)
    check(same_hg, "(x): the live hg after the in-place restore differs "
          "from the re-split row")
    check(digest == ring["digest_at_ckpt"], "(x): the restored parameters "
          "and momentum differ from rank 0's at the checkpoint")
    check(key[4] == 1 and key[6] == (("data", 1),) and key[4] != ring[
        "plan_key"][4], f"(x): plan key {key}, two ranks' "
          f"{ring['plan_key']}")
    check(max(rel) <= ELASTIC_RTOL < min(controls.values()), f"(x): losses "
          f"{losses} against the two ranks' {two}: relative {rel}, the "
          f"controls {controls}, the bound {ELASTIC_RTOL}")
    check(counts == want, f"(x): counts {counts}, the plans say {want}")
    clear_checkpoints()
    return dict(losses=losses, two_rank_losses=two, relative_diff=rel,
                rtol=ELASTIC_RTOL, control_max_relative_diff=controls,
                live_hg_is_resplit_row=same_hg, plan_key=repr(key),
                theta=theta, two_rank_plan_key=repr(tuple(ring["plan_key"])),
                two_rank_theta=ring["theta"],
                hg_rows_saved=meta["gf/hg"]["shape"],
                restore_s=ckpt.restores, save_s=ckpt.saves,
                writer=ckpt.writes, reshard_s=reshard_s,
                two_rank_writes=ring["writes"],
                dispatch_counts=counts, same_params_as_rank0_at=ELASTIC_AT)


COMMON_ARGV = ["--arch", "smollm-135m", "--use-kernels", "--bucket-elems",
               str(BUCKET_ELEMS), "--batch", str(BATCH), "--seq-len",
               str(SEQ), "--log-every", "1", "--window-steps", "1"]
LAZY_ARGV = COMMON_ARGV + ["--gf-mode", "lazy", "--steps", str(LAZY_STEPS)]
CSC_ARGV = COMMON_ARGV + ["--gf-mode", "csc", "--chunk-elems", str(CHUNK),
                          "--sparsity", str(CSC_SPARSITY), "--csc-warmup",
                          str(CSC_WARMUP), "--steps", str(CSC_STEPS)]


def train_phase(torch, dist, ops, train_mod, synthetic, kunpack, csc,
                wire):
    """The full-width step in one world-size-1 NCCL group, each run with
    its own dispatch counts: (a) lazy and (b) CSC with momentum SGD;
    (d) LARS, CSC, staged; (e) LARS, lazy, staged then monolithic; (f)
    AdamW, CSC, staged; the guard, (g)-(j); the low-bit wires, (l)-(o)."""
    lazy_args, csc_args = LAZY_ARGV, CSC_ARGV
    lars = ["--optimizer", "lars", "--lr", str(LARS_LR)]
    # The low-bit wires' lazy runs chunk the pool as CSC does.
    int8 = ["--wire-format", "int8"]
    int8_lazy_args = lazy_args + ["--chunk-elems", str(CHUNK)] + int8
    fp8_lazy_args = lazy_args + ["--chunk-elems", str(CHUNK),
                                 "--wire-format", "fp8_e4m3"]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    runs = {}
    try:
        runs["lazy"] = train_run(torch, ops, train_mod, synthetic, "lazy",
                                 lazy_args, LAZY_STEPS)
        runs["csc"] = train_run(torch, ops, train_mod, synthetic, "csc",
                                csc_args, CSC_STEPS)
        tally, restore = count_ratio_launches(kunpack)
        try:
            runs["lars_csc"] = train_run(torch, ops, train_mod, synthetic,
                                         "(d) lars, csc, staged",
                                         csc_args + lars, CSC_STEPS)
        finally:
            restore()
        runs["lars_csc"]["update_launches"] = dict(tally)
        lars_lazy = {}
        for overlap in ("staged", "monolithic"):
            lars_lazy[overlap] = train_run(
                torch, ops, train_mod, synthetic,
                f"(e) lars, lazy, {overlap}", lazy_args + lars, LAZY_STEPS,
                overlap=overlap, keep_params=True)
        runs["adamw_csc"] = train_run(
            torch, ops, train_mod, synthetic, "(f) adamw, csc, staged",
            csc_args + ["--optimizer", "adamw", "--lr", str(ADAMW_LR)],
            CSC_STEPS)
        runs["guarded_lazy"] = guarded_run(
            torch, ops, train_mod, "(g) guarded lazy, staged", lazy_args,
            GUARD_LAZY_STEPS, GUARD_LAZY_FAULTS)
        runs["guarded_csc"] = guarded_run(
            torch, ops, train_mod, "(h) guarded csc, staged", csc_args,
            CSC_STEPS, GUARD_CSC_FAULTS, steady_from=CSC_WARMUP)
        runs["guarded_lars_lazy_monolithic"] = guarded_run(
            torch, ops, train_mod, "(i) guarded lars, lazy, monolithic",
            lazy_args + lars, LAZY_STEPS, GUARD_MONO_FAULTS,
            overlap="monolithic")
        runs["neutral_lazy"] = neutrality_run(
            torch, ops, train_mod, synthetic, lazy_args, LAZY_STEPS)
        runs["int8_lazy"] = train_run(
            torch, ops, train_mod, synthetic, "(l) int8, lazy, staged",
            int8_lazy_args, LAZY_STEPS,
            watch={1: watch_error_feedback(torch, wire)})
        runs["int8_csc"] = train_run(
            torch, ops, train_mod, synthetic, "(m) int8, csc, staged",
            csc_args + int8, CSC_STEPS,
            watch={CSC_STEPS - 1: watch_residual_at_selection(torch, csc)})
        fp8 = {}
        for overlap in ("staged", "monolithic"):
            fp8[overlap] = train_run(
                torch, ops, train_mod, synthetic,
                f"(n) fp8-e4m3, lazy, {overlap}", fp8_lazy_args, LAZY_STEPS,
                overlap=overlap, keep_params=True)
        runs["guarded_int8_lazy"] = guarded_run(
            torch, ops, train_mod, "(o) guarded int8, lazy, staged",
            int8_lazy_args, GUARD_LAZY_STEPS, GUARD_LAZY_FAULTS)
        runs["guarded_int8_csc"] = guarded_run(
            torch, ops, train_mod, "(o) guarded int8, csc, staged",
            csc_args + int8, CSC_STEPS, GUARD_CSC_FAULTS,
            steady_from=CSC_WARMUP)
        runs["window_lazy"], twin = window_run(
            torch, dist, ops, train_mod, "(q) lazy, graphed window",
            lazy_args, 0)
        runs["window_lazy_pipelined"], _ = window_run(
            torch, dist, ops, train_mod, "(r) lazy, pipelined graphed window",
            lazy_args, PIPELINE_TAIL, twin=twin)
        runs["window_csc_cli"] = csc_window_run(
            torch, ops, train_mod, "(s) csc, CLI windows",
            csc_args + ["--csc-warmup", str(CSC_WINDOW_WARMUP), "--steps",
                        str(CSC_WINDOW_STEPS), "--window-steps",
                        str(CSC_WINDOW_K)])
        runs["window_guarded_lazy"], gtwin = guarded_window_run(
            torch, ops, train_mod, "(t) guarded lazy, graphed window",
            lazy_args, 0, GUARD_LAZY_FAULTS,
            runs["guarded_lazy"]["losses"])
        runs["window_guarded_lazy_pipelined"], _ = guarded_window_run(
            torch, ops, train_mod,
            "(t) guarded lazy, pipelined graphed window", lazy_args,
            PIPELINE_TAIL, GUARD_LAZY_FAULTS,
            runs["guarded_lazy"]["losses"], twin=gtwin)
        runs["supervisor_lazy_window"] = supervisor_run(
            torch, ops, train_mod, "(v) lazy windows under the supervisor",
            lazy_args)
    finally:
        dist.destroy_process_group()
    for label in ("csc", "lars_csc"):
        got = runs[label]["dispatch_counts"]
        check(got == CSC_COUNTS, f"{label}: dispatch counts {got}, "
              f"expected {CSC_COUNTS}")
    got = runs["adamw_csc"]["dispatch_counts"]
    check(got == ADAMW_CSC_COUNTS, f"adamw_csc: dispatch counts {got}, "
          f"expected {ADAMW_CSC_COUNTS}")
    tally = runs["lars_csc"]["update_launches"]
    check(tally == {"with_ratios": 2 * CSC_COUNTS[
        "pool_unpack_update.kernel"], "without_ratios": 0},
          f"lars_csc: update launches {tally}: each must carry ratios")
    for label in ("csc", "lars_csc", "adamw_csc", "int8_csc",
                  "guarded_int8_csc"):
        check(runs[label]["num_selected"] == [4106, 3233, 2361, 1488]
              + [616] * 4, f"{label}: stages select "
              f"{runs[label]['num_selected']}")
    # (l): the padded pool's 7 buckets (the last padding only, as CSC's
    # warm-up has) and the census sum: 8 all-reduces a step, 7 updates.
    got = runs["int8_lazy"]
    check(got["dispatch_counts"] == {
        "pool_pack.kernel": 2 * LAZY_STEPS,
        "pool_unpack_update.kernel": 7 * LAZY_STEPS}
          and got["collectives"] == 8 * LAZY_STEPS,
          f"(l): counts {got['dispatch_counts']}, all-reduces "
          f"{got['collectives']}")
    check(got["wire_bytes_per_step"] == [WIRE_LAZY_BYTES["int8"]]
          * LAZY_STEPS and runs["lazy"]["wire_bytes_per_step"]
          == [WIRE_LAZY_BYTES["native"]] * LAZY_STEPS,
          f"(l) wire bytes {got['wire_bytes_per_step']} against (a)'s "
          f"{runs['lazy']['wire_bytes_per_step']}")
    # (m): the native warm-up, then k = 616 on int8 with its census.
    got = runs["int8_csc"]
    check(got["wire_bytes_per_step"][-1] == WIRE_CSC_K616_BYTES
          and got["wire_bytes_per_step"][0]
          == runs["csc"]["wire_bytes_per_step"][0],
          f"(m) wire bytes {got['wire_bytes_per_step']}")
    # (n): staged and monolithic from one seed on one batch, bit for bit.
    (staged8, p8s), (mono8, p8m) = fp8["staged"], fp8["monolithic"]
    same = staged8["repeated_batch_losses"] == mono8[
        "repeated_batch_losses"] and bits_equal(torch, p8s, p8m)
    fp8_diff = (p8s - p8m).abs().max().item()
    check(same, f"(n) fp8 lazy: staged != monolithic (losses "
          f"{staged8['repeated_batch_losses']} vs "
          f"{mono8['repeated_batch_losses']}, largest parameter difference "
          f"{fp8_diff})")
    del p8s, p8m
    torch.cuda.empty_cache()
    mono8["bitwise_equal_to_staged"] = same
    runs["fp8_lazy"], runs["fp8_lazy_monolithic"] = staged8, mono8
    # (e): staged and monolithic from one seed on one batch.
    (staged, p_staged), (mono, p_mono) = (lars_lazy["staged"],
                                          lars_lazy["monolithic"])
    a, b = staged["repeated_batch_losses"], mono["repeated_batch_losses"]
    check(all(abs(x - y) <= 1e-6 * abs(y) for x, y in zip(a, b)),
          f"(e) lars lazy: staged losses {a} != monolithic {b} (rtol 1e-6)")
    max_param_diff = (p_staged - p_mono).abs().max().item()
    print(f"(e) lars lazy, staged vs monolithic on one batch: largest "
          f"parameter difference {max_param_diff}", flush=True)
    del p_staged, p_mono
    torch.cuda.empty_cache()
    mono["max_param_diff_vs_staged"] = max_param_diff
    runs["lars_lazy"], runs["lars_lazy_monolithic"] = staged, mono
    for label, run in runs.items():
        if "steady_step_ms" in run or "step_ms" not in run:
            continue  # the guarded runs count their clean steps only
        steady = run["step_ms"][CSC_WARMUP if "csc" in label else 1:]
        run["first_step_ms"] = run["step_ms"][0]
        run["steady_step_ms"] = statistics.median(steady)
        run["tokens_per_s"] = BATCH * SEQ / (run["steady_step_ms"] / 1e3)
    for guarded, plain in GUARD_PAIRS.items():
        g, u = runs[guarded]["steady_step_ms"], runs[plain]["steady_step_ms"]
        runs[guarded].update(unguarded=plain, unguarded_steady_step_ms=u,
                             steady_delta_pct=100.0 * (g - u) / u)
    for low, native in WIRE_PAIRS.items():
        w, u = runs[low]["steady_step_ms"], runs[native]["steady_step_ms"]
        runs[low].update(native_twin=native, native_steady_step_ms=u,
                         steady_delta_pct=100.0 * (w - u) / u,
                         native_peak_mem_gib=runs[native]["peak_mem_gib"])
    return runs


# Each guarded run and the unguarded run of this call it is timed against.
GUARD_PAIRS = {"guarded_lazy": "lazy", "guarded_csc": "csc",
               "guarded_lars_lazy_monolithic": "lars_lazy_monolithic",
               "guarded_int8_lazy": "int8_lazy",
               "guarded_int8_csc": "int8_csc"}
# Each low-bit run and its bf16 twin of this call (one rank: no wire
# saved, the quantize, dequantize and residual passes added).
WIRE_PAIRS = {"int8_lazy": "lazy", "int8_csc": "csc", "fp8_lazy": "lazy",
              "fp8_lazy_monolithic": "lazy"}


RING_STEPS = 3  # on the stream, then as many on one repeated batch
RING_CSC_STEPS = CSC_WARMUP + 1  # the dense step, the ramp, one steady step
# (k): the guarded lazy ring run, a NaN on rank 0 only at step 2.
RING_GUARD_STEPS, RING_GUARD_FAULT = 4, (2, "nan", 1_000_000, GUARD_WIDTH)


def ring_train_worker(rank: int, port: int, out: str,
                      elastic_dir: str) -> None:
    """One rank of the ring runs (a process of its own): smollm-135m at
    full width and depth, bf16 wire, momentum SGD, kernels on,
    ``collective_algo="pallas_ring"``, world size 2 over gloo (NCCL
    refuses two ranks on one card), this rank's half of each global
    batch. First lazy mode, then CSC through its dense step, its ramp and
    one steady step (the ring then reduces the compacted wire buffer);
    last (x), CSC under the supervisor with checkpoints in
    ``elastic_dir``. Writes its findings to ``out`` as JSON."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ring_reduce as kring
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.trainer import Trainer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    common = ["--arch", "smollm-135m", "--use-kernels", "--bucket-elems",
              str(BUCKET_ELEMS), "--batch", str(BATCH), "--seq-len", str(SEQ),
              "--window-steps", "1"]

    def ring_trainer(extra, guard=None, tail=0):
        args = train_mod.parse_args(common + extra)
        _, cfg = train_mod.build(args)
        cfg = cfg.replace(gradientflow=dataclasses.replace(
            cfg.gradientflow, collective_algo="pallas_ring", guard=guard,
            pipeline_tail_buckets=tail))
        return args, cfg, Trainer(cfg)

    def digest(trainer, state):
        flat = torch.cat([p.reshape(-1) for p in
                          trainer.pool.flat_leaves(state.params)])
        return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

    def drive_window(trainer, args, cfg, windows, batch_of):
        """(u): ``windows`` windows of RING_WINDOW_K steps, each a replay
        of one CUDA graph, on the batches ``batch_of(step)``; the losses,
        the launches of the warm-up, of the capture and in all, and
        whether the ranks held the same parameters after every window."""
        from repro_torch.launch.trainer import is_flushed

        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        state = trainer.init_state(args.seed)
        window = trainer.build_train_window(RING_WINDOW_K)
        plan = trainer.engine.plan_for()
        ops.reset_counts()
        losses, digests = [], []
        for w in range(windows):
            steps = range(w * RING_WINDOW_K, (w + 1) * RING_WINDOW_K)
            bs = [data.batch(batch_of(s), BATCH // 2, SEQ, shard=rank)
                  for s in steps]
            state, m = window(state, {k: torch.stack([b[k] for b in bs])
                                      for k in bs[0]})
            losses += m["loss"].tolist()
            digests.append(digest(trainer, state))
        both = [None, None]
        dist.all_gather_object(both, digests)
        out = dict(losses=losses, counts=dict(ops.dispatch_counts),
                   stats=dict(window.stats), tasks=len(plan.tasks),
                   pipeline_tail=plan.pipeline_tail,
                   flushed=is_flushed(state),
                   same_params_every_window=both[0] == both[1])
        window.release()
        return out

    def drive(trainer, args, cfg, steps, batch_of, hook=None):
        """``steps`` steps on the batches ``batch_of(step)``, each under
        its stage (and the fault hook, if any); the counts, the losses,
        the step times, the guard's verdicts and whether the ranks held
        the same parameters after every step."""
        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        state = trainer.init_state(args.seed)
        fns, losses, step_ms, digests, tripped = {}, [], [], [], []
        stages = [trainer.gf.stage_for_step(s) for s in range(steps)]
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        for s, stage in enumerate(stages):
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(
                    stage, fault_hook=hook)
            batch = data.batch(batch_of(s), BATCH // 2, SEQ, shard=rank)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fns[stage.index](state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if "guard_tripped" in metrics:
                tripped.append(float(metrics["guard_tripped"]))
            flat = torch.cat([p.reshape(-1) for p in
                              trainer.pool.flat_leaves(state.params)])
            digests.append(hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest())
            del flat
        counts = dict(ops.dispatch_counts)
        peak = torch.cuda.max_memory_allocated()
        residual_finite = bool(torch.isfinite(state.gf.residual).all())
        both = [None, None]
        dist.all_gather_object(both, digests)
        plans = [trainer.gf.plan(st) for st in stages]
        want = expected_counts(trainer, steps)
        want["ring_allreduce.kernel"] = sum(len(p.tasks) for p in plans)
        return dict(losses=losses, step_ms=step_ms, counts=counts,
                    expected_counts=want,
                    buckets=[len(p.tasks) for p in plans],
                    num_selected=[st.num_selected for st in stages],
                    peak_mem_gib=peak / 2 ** 30,
                    same_params_every_step=both[0] == both[1],
                    residual_finite=residual_finite,
                    digests=digests, tripped=tripped,
                    skipped=int(state.guard.skipped) if tripped else None)

    def drive_elastic(trainer, args, cfg):
        """(x): ELASTIC_STEPS eager CSC steps under
        ``TrainSupervisor.run_windows`` (window 1), batches from a
        ``DataPipeline`` of this rank's shard, a collective checkpoint
        every ELASTIC_AT steps into ``elastic_dir`` and a final one.
        Returns the losses, a digest of the parameters and momentum the
        checkpoint at ELASTIC_AT holds, the plan key, θ and the writes."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.data.pipeline import DataPipeline
        from repro_torch.runtime.fault_tolerance import (SupervisorConfig,
                                                         TrainSupervisor)

        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        pipe = DataPipeline(data, BATCH // 2, SEQ, shard=rank, prefetch=0)
        ckpt = CheckpointManager(elastic_dir)
        sup = TrainSupervisor(ckpt, SupervisorConfig(
            checkpoint_every=ELASTIC_AT))
        fns, losses, found = {}, [], {}

        def window_fn(step, length, state):
            if step == ELASTIC_AT:
                flat = torch.cat([p.reshape(-1) for p in
                                  trainer.pool.flat_leaves(state.params)]
                                 + [state.opt.momentum]).cpu()
                found["digest"] = hashlib.sha256(
                    flat.numpy().tobytes()).hexdigest()
            stage = trainer.gf.stage_for_step(step)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, m = fns[stage.index](state, pipe.next_at(step))
            losses.append(float(m["loss"]))
            return state

        ops.reset_counts()
        pipe.start(0)
        try:
            sup.run_windows(trainer.init_state(args.seed), 0, ELASTIC_STEPS,
                            window_fn, 1, on_restore=pipe.skip_to)
        finally:
            pipe.stop()
        plans = [trainer.gf.plan(trainer.gf.stage_for_step(s))
                 for s in range(ELASTIC_STEPS)]
        want = expected_counts(trainer, ELASTIC_STEPS)
        want["ring_allreduce.kernel"] = sum(len(p.tasks) for p in plans)
        return dict(losses=losses, digest_at_ckpt=found["digest"],
                    plan_key=list(trainer.gf.plan_cache_key()),
                    theta=trainer.gf.bucket_elems, writes=ckpt.writes,
                    counts=dict(ops.dispatch_counts), expected_counts=want,
                    restarts=sup.restarts)

    result = {"rank": rank}
    csc_flags = ["--gf-mode", "csc", "--chunk-elems", str(CHUNK),
                 "--sparsity", str(CSC_SPARSITY), "--csc-warmup",
                 str(CSC_WARMUP)]
    try:
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"])
        plan = trainer.engine.plan_for(None)
        check(all(t.algo.name == "pallas_ring" for t in plan.tasks),
              f"buckets' algorithms {[t.algo for t in plan.tasks]}")
        # Capture the first step's packed pool and its post-reduce pool
        # (the ring sums each bucket in place in the wire pool).
        captured = {}
        run = trainer.engine.run

        def capture(plan_, gpool, *a, **k):
            if captured:
                return run(plan_, gpool, *a, **k)
            captured["pre"] = gpool.detach().cpu().clone()
            outs = run(plan_, gpool, *a, **k)
            torch.cuda.synchronize()
            captured["post"] = gpool.detach().cpu().clone()
            return outs

        trainer.engine.run = capture
        result["lazy"] = drive(trainer, args, cfg, 2 * RING_STEPS,
                               lambda s: min(s, RING_STEPS))
        # The first step's post-reduce pool against the plain ring of the
        # two ranks' packed pools, on rank 0's CPU.
        pre = captured["pre"].view(torch.int16)
        post = captured["post"].view(torch.int16)
        if rank == 1:
            dist.send(pre, 0)
            dist.send(post, 0)
        else:
            pre1, post1 = torch.empty_like(pre), torch.empty_like(post)
            dist.recv(pre1, 1)
            dist.recv(post1, 1)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ok = True
            for t in plan.tasks:
                xs = [x[t.start:t.end].view(torch.bfloat16)
                      for x in (pre, pre1)]
                seg = kring.plan(t.size, 2, torch.bfloat16,
                                 sms=sms)["seg_elems"]
                want = ref.ring_allreduce_ranks(xs, seg_elems=seg)[0]
                ok &= torch.equal(want.view(torch.int16),
                                  post[t.start:t.end])
                ok &= torch.equal(want.view(torch.int16),
                                  post1[t.start:t.end])
            result["first_step_matches_plain_ring"] = bool(ok)
        del trainer, captured, pre, post
        torch.cuda.empty_cache()

        # (k) guarded, a NaN written into rank 0's pool only: the ring
        # carries it to rank 1 in-band, so both ranks must trip.
        from repro_torch.configs.base import GuardConfig
        from repro_torch.runtime.faults import make_hook
        hook = make_hook(fault_events([RING_GUARD_FAULT])) \
            if rank == 0 else None
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"],
                                          guard=GuardConfig())
        result["lazy_guarded"] = drive(trainer, args, cfg, RING_GUARD_STEPS,
                                       lambda s: s, hook=hook)
        del trainer
        torch.cuda.empty_cache()

        args, cfg, trainer = ring_trainer(csc_flags)
        result["csc"] = drive(trainer, args, cfg, RING_CSC_STEPS,
                              lambda s: s)
        del trainer
        torch.cuda.empty_cache()

        # (p) the int8 wire over the ring, lazy then CSC: the dtype of the
        # words of every ring launch is recorded.
        words = {}
        launch = kring.launch

        def recorded(x, *a, **k):
            key = str(x.dtype).split(".")[-1]
            words[key] = words.get(key, 0) + 1
            return launch(x, *a, **k)

        kring.launch = recorded
        try:
            int8 = ["--wire-format", "int8"]
            args, cfg, trainer = ring_trainer(
                ["--gf-mode", "lazy", "--chunk-elems", str(CHUNK)] + int8)
            words.clear()
            result["int8_lazy"] = drive(trainer, args, cfg, 2 * RING_STEPS,
                                        lambda s: min(s, RING_STEPS))
            result["int8_lazy"]["ring_words"] = dict(words)
            del trainer
            torch.cuda.empty_cache()
            args, cfg, trainer = ring_trainer(csc_flags + int8)
            words.clear()
            result["int8_csc"] = drive(trainer, args, cfg, RING_CSC_STEPS,
                                       lambda s: s)
            result["int8_csc"]["ring_words"] = dict(words)
            del trainer
        finally:
            kring.launch = launch
        torch.cuda.empty_cache()

        # (u) the lazy window as a CUDA graph on both ranks with a
        # deferred tail, on the batches of the lazy run above.
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"],
                                          tail=PIPELINE_TAIL)
        result["lazy_window"] = drive_window(
            trainer, args, cfg, 2 * RING_STEPS // RING_WINDOW_K,
            lambda s: min(s, RING_STEPS))
        del trainer
        torch.cuda.empty_cache()

        # (x) CSC under the supervisor, a checkpoint at ELASTIC_AT.
        args, cfg, trainer = ring_trainer(
            csc_flags + ["--steps", str(ELASTIC_STEPS)])
        result["elastic"] = drive_elastic(trainer, args, cfg)
        del trainer
        kring.release_workspaces()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def ring_ranks():
    """The two ring processes (``ring_train_worker``), run to their end;
    (their records, the directory of (x)'s checkpoints)."""
    port = free_port()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"ring_train_rank{r}.json")
            for r in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    elastic_dir = ckpt_dir("x")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ring-rank", str(r), "--port", str(port),
                               "--out", outs[r], "--elastic-dir",
                               elastic_dir]) for r in range(2)]
    try:
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("ring train run: ranks did not finish within 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"ring train run: rank exit codes {[p.returncode for p in procs]}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    # (x): both ranks log the same losses and a checkpoint at ELASTIC_AT
    # and at the end, one row of hg each in it (checked by elastic_phase).
    for r in ranks:
        got = r["elastic"]
        check(got["losses"] == ranks[0]["elastic"]["losses"]
              and len(got["losses"]) == ELASTIC_STEPS
              and got["restarts"] == 0
              and got["counts"] == got["expected_counts"]
              and all(math.isfinite(x) for x in got["losses"]),
              f"(x) rank {r['rank']}: {got}")
    check([w["step"] for w in ranks[0]["elastic"]["writes"]]
          == [ELASTIC_AT, ELASTIC_STEPS] and not ranks[1]["elastic"]["writes"],
          f"(x): writes rank 0 {ranks[0]['elastic']['writes']}, rank 1 "
          f"{ranks[1]['elastic']['writes']}")
    return ranks, elastic_dir


def ring_train_phase(torch, dev):
    """(c) the ring in the trainer: two processes on the one card, one
    rank each, over the cross-process (IPC) ring workspace; lazy, then
    CSC; last (x)'s two-rank part."""
    mode = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"compute mode: {mode.stdout.strip()}", flush=True)
    ranks, elastic_dir = ring_ranks()
    runs = {}
    for label in ("lazy", "csc", "int8_lazy", "int8_csc"):
        for r in ranks:
            got = r[label]
            check(got["residual_finite"],
                  f"ring train {label}: non-finite residual")
            check(got["counts"] == got["expected_counts"],
                  f"ring train {label} rank {r['rank']}: dispatch counts "
                  f"{got['counts']}, expected {got['expected_counts']}")
            check(got["same_params_every_step"],
                  f"ring train {label}: the ranks' parameters differ")
            check(all(math.isfinite(x) for x in got["losses"]),
                  f"ring train {label}: non-finite loss {got['losses']}")
        check(ranks[0][label]["losses"] == ranks[1][label]["losses"],
              f"ring train {label}: the ranks logged different losses")
        runs[label] = ranks[0][label]
    for label in ("lazy", "int8_lazy"):
        rep = runs[label]["losses"][RING_STEPS:]
        check(rep[-1] < rep[0], f"ring train {label}: loss did not fall on "
              f"one batch: {rep}")
    # (p): every lazy ring launch carries int8 words; CSC's dense warm-up
    # step stays bf16 (native), its sparse steps' buckets carry int8.
    key = "ring_allreduce.kernel"
    for r in ranks:
        lazy8, csc8 = r["int8_lazy"], r["int8_csc"]
        want_csc = {"bfloat16": csc8["buckets"][0],
                    "int8": sum(csc8["buckets"][1:])}
        check(lazy8["ring_words"] == {"int8": lazy8["counts"][key]},
              f"(p) rank {r['rank']}: lazy ring words {lazy8['ring_words']}")
        check(csc8["ring_words"] == want_csc and csc8["counts"][key]
              == sum(csc8["buckets"]),
              f"(p) rank {r['rank']}: CSC ring words {csc8['ring_words']}, "
              f"expected {want_csc}")
    check(ranks[0]["first_step_matches_plain_ring"],
          "ring train: the first step's post-reduce pool != the plain ring "
          "of the two ranks' packed pools")
    check(runs["csc"]["num_selected"][-1] < runs["csc"]["num_selected"][0],
          f"ring train csc: no sparse step ({runs['csc']['num_selected']})")
    # (k): both ranks trip at the faulted step only, keep the same
    # parameters (the skip: the digests before and after it are equal),
    # and launch the ring exactly as often a step as the unguarded run.
    fault_step = RING_GUARD_FAULT[0]
    want_trips = [float(s == fault_step) for s in range(RING_GUARD_STEPS)]
    per_step = ranks[0]["lazy"]["counts"][key] / (2 * RING_STEPS)
    for r in ranks:
        got = r["lazy_guarded"]
        check(got["tripped"] == want_trips and got["skipped"] == 1,
              f"ring guarded rank {r['rank']}: tripped {got['tripped']}")
        check(got["digests"][fault_step] == got["digests"][fault_step - 1],
              f"ring guarded rank {r['rank']}: the tripped step changed "
              f"the parameters")
        check(got["counts"] == got["expected_counts"]
              and got["counts"][key] == per_step * RING_GUARD_STEPS,
              f"ring guarded rank {r['rank']}: counts {got['counts']}, "
              f"unguarded {per_step} ring launches a step")
        check(got["same_params_every_step"],
              "ring guarded: the ranks' parameters differ")
    # (u): every ring launch of the windows is the warm-up body's or the
    # capture's (the replays run the rest); the losses are the eager lazy
    # run's on the same batches, bit for bit, on both ranks.
    for r in ranks:
        got = r["lazy_window"]
        st, tasks = got["stats"], got["tasks"]
        check(got["pipeline_tail"] == PIPELINE_TAIL and got["flushed"],
              f"(u) rank {r['rank']}: tail {got['pipeline_tail']}, flushed "
              f"{got['flushed']}")
        check(st["capture_counts"].get(key) == RING_WINDOW_K * tasks
              and st["warmup_counts"].get(key) == tasks
              and got["counts"][key] == (RING_WINDOW_K + 1) * tasks
              and st["captures"] == 1
              and st["replays"] == 2 * RING_STEPS // RING_WINDOW_K,
              f"(u) rank {r['rank']}: ring launches {got['counts']}, "
              f"window stats {st}")
        check(got["losses"] == r["lazy"]["losses"],
              f"(u) rank {r['rank']}: window losses {got['losses']} != the "
              f"eager run's {r['lazy']['losses']}")
        check(got["same_params_every_window"],
              "(u): the ranks' parameters differ after a window")
    note = ("world size 2 as two processes on one card: the ranks take "
            "turns on the device, so a step time is no wire's; the ring "
            "runs through this card's memory, not NVLink")
    lazy, csc_run = runs["lazy"], runs["csc"]
    return (ranks[0]["elastic"], elastic_dir,
            dict(losses=lazy["losses"][:RING_STEPS],
                 repeated_batch_losses=lazy["losses"][RING_STEPS:],
                 step_ms=[r["lazy"]["step_ms"] for r in ranks],
                 steady_step_ms=statistics.median(
                     lazy["step_ms"][1:RING_STEPS]),
                 dispatch_counts=lazy["counts"],
                 peak_mem_gib=[r["lazy"]["peak_mem_gib"] for r in ranks],
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=csc_run["losses"],
                 step_ms=[r["csc"]["step_ms"] for r in ranks],
                 num_selected=csc_run["num_selected"],
                 ring_buckets=csc_run["buckets"],
                 dispatch_counts=csc_run["counts"],
                 peak_mem_gib=[r["csc"]["peak_mem_gib"] for r in ranks],
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=[r["lazy_guarded"]["losses"] for r in ranks],
                 tripped=[r["lazy_guarded"]["tripped"] for r in ranks],
                 fault=list(RING_GUARD_FAULT) + ["rank 0"],
                 step_ms=[r["lazy_guarded"]["step_ms"] for r in ranks],
                 dispatch_counts=ranks[0]["lazy_guarded"]["counts"],
                 unguarded_ring_launches_per_step=per_step,
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=ranks[0]["lazy_window"]["losses"],
                 window_stats=[r["lazy_window"]["stats"] for r in ranks],
                 dispatch_counts=ranks[0]["lazy_window"]["counts"],
                 pipeline_tail=PIPELINE_TAIL, window_steps=RING_WINDOW_K,
                 same_bits_as="the eager lazy ring run",
                 compute_mode=mode.stdout.strip(), note=note),
            *(dict(losses=runs[label]["losses"],
                   step_ms=[r[label]["step_ms"] for r in ranks],
                   num_selected=runs[label]["num_selected"],
                   ring_buckets=runs[label]["buckets"],
                   ring_words=runs[label]["ring_words"],
                   dispatch_counts=runs[label]["counts"],
                   peak_mem_gib=[r[label]["peak_mem_gib"] for r in ranks],
                   same_params_every_step=True, wire_format="int8",
                   compute_mode=mode.stdout.strip(), note=note)
              for label in ("int8_lazy", "int8_csc")))


def main() -> None:
    import torch
    if "--ring-rank" in sys.argv:
        argv = sys.argv[1:]
        ring_train_worker(int(argv[argv.index("--ring-rank") + 1]),
                          int(argv[argv.index("--port") + 1]),
                          argv[argv.index("--out") + 1],
                          argv[argv.index("--elastic-dir") + 1])
        return
    if "--cli-train" in sys.argv:
        argv = sys.argv[1:]
        head = argv[:argv.index("--")]
        cli_worker(head[head.index("--cli-train") + 1],
                   argv[argv.index("--") + 1:],
                   int(head[head.index("--preempt-at") + 1])
                   if "--preempt-at" in head else None)
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        sys.exit(2)
    argv = sys.argv[1:]
    # --short-kernels [--src DIR]: only the census and the gather phases,
    # on the kernels of the tree at DIR (e.g. a parent's checkout, to time
    # both trees the same way in one call).
    short_only = "--short-kernels" in argv
    src = os.path.abspath(argv[argv.index("--src") + 1]) if "--src" in argv \
        else os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is missing under {src}",
              file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import pool as pool_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import chunk_l1norm as kcl
    from repro_torch.kernels import csc_compact as kcc
    from repro_torch.models import build_model

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    power = smi_line.split(",")[-1].strip()
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    print(f"device: {name}; nvidia-smi: {smi_line}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; memory-rate "
          f"bound at {rate / 1e12} TB/s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, one "
          f"process per source, in parallel)", flush=True)
    for lib in build.SOURCES:
        for line in build.build_log(lib).splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                print(f"  {lib}: {line.strip()}")

    dev = torch.device("cuda", 0)
    shapes = build_model(get_arch("smollm-135m")[0]).param_shapes()
    num_chunks = pool_mod.GradientPool(shapes, pad_to=CHUNK).size // CHUNK
    if short_only:
        # The parent's wrappers may take no grid: time, do not vary it.
        own = src == os.path.join(ROOT, "src")
        for e in (census_phase(torch, kcl, num_chunks, dev, rate, own),
                  compact_phase(torch, kcc, num_chunks, dev, rate, own)):
            print(json.dumps(dict(kernel=e["name"], src=src, gpu=name,
                                  power_limit=power, parts=e["parts"])),
                  flush=True)
        print(smi_line)
        return
    make_ckpt_root()
    try:
        run_all(torch, dist, dev, rate, name, power, smi_line, shapes,
                num_chunks)
    finally:
        remove_ckpt_root()


def run_all(torch, dist, dev, rate, name, power, smi_line, shapes,
            num_chunks):
    """Every phase after the build (see the module docstring); the
    result line last."""
    from repro_torch.core import csc
    from repro_torch.core import pool as pool_mod
    from repro_torch.core import wire
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.kernels import chunk_l1norm as kcl
    from repro_torch.kernels import csc_compact as kcc
    from repro_torch.kernels import fused_update as kfu
    from repro_torch.kernels import ring_reduce as kring
    from repro_torch.kernels import pool_pack as kpack
    from repro_torch.kernels import pool_unpack as kunpack
    from repro_torch.launch import train as train_mod
    from repro_torch import optim
    from repro_torch.configs import base
    from repro_torch.optim import lars as lars_mod

    entries = [
        pack_phase(torch, pool_mod, kpack, shapes, dev, rate),
        update_phase(torch, pool_mod, csc, kunpack, shapes, dev, rate),
        census_phase(torch, kcl, num_chunks, dev, rate),
        compact_phase(torch, kcc, num_chunks, dev, rate),
        ring_phase(torch, kring, pool_mod, shapes, dev, rate),
        fused_update_phase(torch, kfu, optim, ops, base, dev, rate)]
    for e in entries:
        print(json.dumps(dict(kernel=e["name"], gpu=name, power_limit=power,
                              parts=e["parts"])), flush=True)
    print(json.dumps(dict(nan_words=nonfinite_phase(
        torch, kpack, kcl, kring, pool_mod, shapes, dev), gpu=name,
        power_limit=power)), flush=True)
    print(json.dumps(dict(optimizer_ops=optimizer_phase(
        torch, pool_mod, csc, optim, lars_mod, base, shapes, dev, rate),
        gpu=name, power_limit=power)), flush=True)
    print(json.dumps(dict(quantized_ring=quantized_ring_phase(
        torch, kring, wire, dev, rate), gpu=name, power_limit=power)),
        flush=True)

    runs = train_phase(torch, dist, ops, train_mod, synthetic, kunpack,
                       csc, wire)
    runs["resume_csc_cli"] = resume_phase("(w) csc, CLI resumed", CSC_ARGV)
    (elastic, elastic_dir, ring, ring_csc, ring_guarded, ring_window,
     ring_int8, ring_int8_csc) = ring_train_phase(torch, dev)
    runs["elastic_csc_2_to_1"] = elastic_phase(
        torch, ops, train_mod, elastic, CSC_ARGV, elastic_dir)
    runs["lazy_pallas_ring_2_processes"] = ring
    runs["csc_pallas_ring_2_processes"] = ring_csc
    runs["guarded_lazy_pallas_ring_2_processes"] = ring_guarded
    runs["int8_lazy_pallas_ring_2_processes"] = ring_int8
    runs["int8_csc_pallas_ring_2_processes"] = ring_int8_csc
    runs["window_lazy_pipelined_pallas_ring_2_processes"] = ring_window
    for label, run in runs.items():
        print(json.dumps(dict(train="smollm-135m", mode=label, batch=BATCH,
                              seq_len=SEQ, gpu=name, power_limit=power,
                              **run)), flush=True)
    for e in entries:
        key = f"{e['name']}.kernel"
        if e["name"] == "ring_allreduce":
            # Rank 0's launches in the two-process ring runs.
            e["launches"] = ring["dispatch_counts"][key]
            e["launches_csc"] = ring_csc["dispatch_counts"][key]
        elif e["name"] == "fused_update":
            e["launches"] = e.pop("launches_update_pool")
        else:
            e["launches"] = runs["csc"]["dispatch_counts"][key]
            e["launches_by_run"] = {
                label: run["dispatch_counts"].get(key, 0)
                for label, run in runs.items() if "pallas" not in label
                and "dispatch_counts" in run}
    check(all(e["launches"] > 0 for e in entries),
          f"launches {[(e['name'], e['launches']) for e in entries]}")
    # Which kernels a captured window launched: (q)'s lazy path, (s)'s
    # CSC stages, (u)'s ring.
    captured = dict(runs["window_lazy"]["capture_counts"])
    for counts in runs["window_csc_cli"]["capture_counts"] + [
            c["capture_counts"] for c in ring_window["window_stats"]]:
        for k, v in counts.items():
            captured[k] = captured.get(k, 0) + v
    for e in entries:
        e["in_graph"] = captured.get(f"{e['name']}.kernel", 0) > 0
        e["graph_capture_launches"] = captured.get(f"{e['name']}.kernel", 0)
    check([e["name"] for e in entries if not e["in_graph"]]
          == ["fused_update"], f"kernels captured in a window: {captured}")
    print(json.dumps(dict(guard_lane_windowed=guard_lane_phase(torch, dev),
                          gpu=name, power_limit=power)), flush=True)
    print(smi_line)
    print(json.dumps({"kernels": entries, "not_ported": [],
                      "gpu": name, "nvidia_smi": smi_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

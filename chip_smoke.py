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
     mask and with per-tensor ratios, and CSC's 7 spans of the padded
     pool with a chunk-granular mask (the last span holds no leaf), bit
     for bit.
   - chunk_l1norm: the census of an f32 pool of 4106 x 32,768 (and of its
     bf16 cast) to 1e-6 relative against the plain version and
     torch.linalg.vector_norm, the same bits on two launches.
   - csc_compact: the gather of k = 616 and k = 3233 sorted chunk ids,
     bit for bit against the plain version and torch.index_select.
3. Train: smollm-135m at full width and depth (batch 16, sequence 1024,
   bf16 wire, momentum SGD, kernels on) inside a world-size-1 NCCL group,
   through the CLI's loop (``repro_torch.launch.train``) on the synthetic
   stream, then through the Trainer it builds on one repeated batch:
   (a) lazy, theta = 4 Mi elements: 6 + 6 steps;
   (b) CSC, chunks of 32,768, sparsity 0.85 reached after 4 warm-up
       steps: step 0 dense (7 buckets), steps 1-3 at k = 3233, 2361,
       1488, steps 4-7 at k = 616 (5 wire buckets); 8 + 8 steps.
   The kernels' dispatch counts are set to 0 just before each run and
   read just after: every kernel of the run's path must have launched,
   exactly as often as its step plans say, and no plain version may have
   run. Every loss must be finite and the repeated batch's last loss below
   its first.

Prints one JSON line per kernel and per train run, the card's nvidia-smi
line, the kernel summary line, then ``{"ok": true, "device": {...}}`` as
the last line. Any failed check ends the run with a non-zero exit before
that line. Exits non-zero without a result when no CUDA device is visible.
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
LAZY_STEPS = 6
CSC_STEPS = 8
CSC_SPARSITY, CSC_WARMUP = 0.85, 4
CSC_KS = (616, 3233)  # the steady stage's k, and the first sparse stage's
# The CSC run's launches, from its step plans: 2 packs a step, 7 update
# spans a step, 1 census a step, 1 gather a sparse step.
CSC_COUNTS = {"pool_pack.kernel": 16, "pool_unpack_update.kernel": 56,
              "chunk_l1norm.kernel": 8, "csc_compact.kernel": 7}

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
    """pool_unpack_update over lazy's 6 spans and CSC's 7."""
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
            # Per-tensor ratios on one span (off the paths; coverage only).
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


def census_phase(torch, kcl, num_chunks, dev, rate):
    """chunk_l1norm on the CSC pool, f32 (the path's form) and bf16."""
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
        if label == "f32":
            part.update(
                ms=time_ms(torch, lambda: kcl.launch(x, CHUNK)),
                plain_ms=time_ms(torch, lambda: kcl.plain(x, CHUNK)),
                library_ms=time_ms(torch, lambda: torch.linalg.vector_norm(
                    x.view(num_chunks, CHUNK), ord=1, dim=1)))
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


def compact_phase(torch, kcc, num_chunks, dev, rate):
    """csc_compact on the CSC pool at the steady and the first sparse k."""
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
        nbytes = 2 * k * CHUNK * 4 + k * 8
        b_ms, b_by = bound_ms(nbytes, 0, rate)
        parts[f"k={k}"] = dict(
            ms=time_ms(torch, lambda: kcc.launch(pool, idx, CHUNK)),
            plain_ms=time_ms(torch, lambda: kcc.plain(pool, idx, CHUNK)),
            library_ms=time_ms(torch, lambda: torch.index_select(
                pool.view(num_chunks, CHUNK), 0, idx)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            max_abs_err=(got - want).abs().max().item())
        del got, want, lib
    del pool
    torch.cuda.empty_cache()
    return entry("csc_compact", "src/repro_torch/kernels/csrc/csc_compact.cu",
                 "src/repro/kernels/csc_compact.py:39", parts,
                 (f"k={CSC_KS[0]}",), COMPACT_LIBRARY_NOTE)


def expected_counts(trainer, steps):
    """The kernel launches ``steps`` steps of this trainer's paths need,
    from its step plans."""
    gf = trainer.gf
    plans = [gf.plan(gf.stage_for_step(s)) for s in range(steps)]
    want = {"pool_pack.kernel": 2 * steps,
            "pool_unpack_update.kernel": sum(len(p.update_spans)
                                             for p in plans)}
    if gf.cfg.csc_enabled:
        want["chunk_l1norm.kernel"] = steps
        want["csc_compact.kernel"] = sum(not p.warmup for p in plans)
    return want


def train_run(torch, ops, train_mod, synthetic, label, argv, steps):
    """(a) ``steps`` steps of the CLI's loop on the synthetic stream,
    timed, and (b) ``steps`` steps of the Trainer it builds on ONE batch,
    each step under the stage the CLI would pick. On a fresh batch each
    step, a few SGD steps at the CLI's learning rate move the loss less
    than the batch-to-batch spread, so (a) cannot show learning; a
    repeated batch can."""
    args = train_mod.parse_args(argv)
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer, losses, seconds = train_mod.train(args)
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

    trainer, cfg = train_mod.build(args)
    state = trainer.init_state(args.seed)
    batch = synthetic.SyntheticLM(cfg.model.vocab_size,
                                  seed=args.seed).batch(0, BATCH, SEQ)
    fns = {}
    ops.reset_counts()
    fixed = []
    for s in range(steps):
        stage = trainer.gf.stage_for_step(s)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        state, metrics = fns[stage.index](state, batch)
        fixed.append(float(metrics["loss"]))
    fixed_counts = dict(ops.dispatch_counts)
    del state, fns, trainer
    torch.cuda.empty_cache()
    print(f"{label}, one batch, repeated: losses {fixed}", flush=True)
    check(fixed_counts == want, f"{label} (repeated batch): dispatch counts "
          f"{fixed_counts}, expected {want}")
    check(all(math.isfinite(x) for x in fixed),
          f"{label}: non-finite loss {fixed}")
    check(fixed[-1] < fixed[0], f"{label}: loss did not fall on one batch: "
          f"{fixed}")
    return dict(losses=losses, repeated_batch_losses=fixed,
                step_ms=[t * 1e3 for t in seconds],
                stage=[s.index for s in stages],
                num_selected=[s.num_selected for s in stages],
                peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts)


def train_phase(torch, dist, ops, train_mod, synthetic):
    """The lazy and the CSC run of the full-width step, each with its own
    dispatch counts, in one world-size-1 NCCL group."""
    common = ["--arch", "smollm-135m", "--use-kernels", "--bucket-elems",
              str(BUCKET_ELEMS), "--batch", str(BATCH), "--seq-len",
              str(SEQ), "--log-every", "1"]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        lazy = train_run(torch, ops, train_mod, synthetic, "lazy",
                         common + ["--gf-mode", "lazy", "--steps",
                                   str(LAZY_STEPS)], LAZY_STEPS)
        csc = train_run(torch, ops, train_mod, synthetic, "csc",
                        common + ["--gf-mode", "csc", "--chunk-elems",
                                  str(CHUNK), "--sparsity", str(CSC_SPARSITY),
                                  "--csc-warmup", str(CSC_WARMUP), "--steps",
                                  str(CSC_STEPS)], CSC_STEPS)
    finally:
        dist.destroy_process_group()
    check(csc["dispatch_counts"] == CSC_COUNTS,
          f"csc: dispatch counts {csc['dispatch_counts']}, expected "
          f"{CSC_COUNTS}")
    check(csc["num_selected"] == [4106, 3233, 2361, 1488] + [616] * 4,
          f"csc: stages select {csc['num_selected']}")
    for run, steady in ((lazy, lazy["step_ms"][1:]),
                        (csc, csc["step_ms"][CSC_WARMUP:])):
        run["first_step_ms"] = run["step_ms"][0]
        run["steady_step_ms"] = statistics.median(steady)
        run["tokens_per_s"] = BATCH * SEQ / (run["steady_step_ms"] / 1e3)
    return lazy, csc


NOT_PORTED = [
    dict(name="fused_update", replaces="src/repro/kernels/fused_update.py:73",
         ported=False),
    dict(name="ring_allreduce", replaces="src/repro/kernels/ring_reduce.py:302",
         ported=False),
]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        sys.exit(2)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is missing under {src}",
              file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import csc
    from repro_torch.core import pool as pool_mod
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import chunk_l1norm as kcl
    from repro_torch.kernels import csc_compact as kcc
    from repro_torch.kernels import pool_pack as kpack
    from repro_torch.kernels import pool_unpack as kunpack
    from repro_torch.launch import train as train_mod
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
    entries = [
        pack_phase(torch, pool_mod, kpack, shapes, dev, rate),
        update_phase(torch, pool_mod, csc, kunpack, shapes, dev, rate),
        census_phase(torch, kcl, num_chunks, dev, rate),
        compact_phase(torch, kcc, num_chunks, dev, rate)]
    for e in entries:
        print(json.dumps(dict(kernel=e["name"], gpu=name, power_limit=power,
                              parts=e["parts"])), flush=True)

    lazy, csc_run = train_phase(torch, dist, ops, train_mod, synthetic)
    for label, run in (("lazy", lazy), ("csc", csc_run)):
        print(json.dumps(dict(train="smollm-135m", mode=label, batch=BATCH,
                              seq_len=SEQ, gpu=name, power_limit=power,
                              **run)), flush=True)
    for e in entries:
        key = f"{e['name']}.kernel"
        e["launches"] = csc_run["dispatch_counts"][key]
        e["launches_lazy"] = lazy["dispatch_counts"].get(key, 0)
    print(smi_line)
    print(json.dumps({"kernels": entries, "not_ported": NOT_PORTED,
                      "gpu": name, "nvidia_smi": smi_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

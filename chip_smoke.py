"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the time to build the CUDA kernels from the sources
   under src/repro_torch/kernels/csrc.
2. Kernels: each kernel of the training step's path against its plain
   PyTorch version on the card, at the main path's shapes (the
   smollm-135m gradient pool: 134,515,008 elements in 11 leaves, 6
   buckets at 4 Mi elements), timed with CUDA events (median of 20 runs
   after 3 warm-up runs). The pack must match bit for bit (pool and
   staging buffer), its chunk census to 1e-6 relative; the update must
   match bit for bit. The pack's library yardstick, ``torch.cat`` into
   the staging buffer, is checked against it and timed (the update has
   no single-call counterpart, so its ``library_ms`` is null).
3. Train: smollm-135m at full width and depth (batch 16, sequence 1024,
   lazy mode, bf16 wire, momentum SGD, kernels on) inside a world-size-1
   NCCL group: six steps of the CLI's loop (``repro_torch.launch.train``)
   on the synthetic stream, timed, and six steps of the Trainer it builds
   on one repeated batch. Every loss must be finite, the repeated batch's
   last loss below its first, and the dispatch counts of each run must
   show 2 pack and 6 update kernel launches a step and no plain-version
   call.

Prints one JSON line per kernel, then the kernel summary line, then
``{"ok": true, "device": {...}}`` as the last line. Any failed check
ends the run with a non-zero exit before that line. Exits non-zero
without a result when no CUDA device is visible.
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

STEPS = 6
BATCH = 16
SEQ = 1024
BUCKET_ELEMS = 4_194_304
CHUNK = 32768
REPS, WARMUP = 20, 3

# Device-memory bandwidth by card (NVIDIA data sheets), for the bounds.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores

UPDATE_LIBRARY_NOTE = ("no single PyTorch call computes this function "
                       "(e.g. torch._fused_sgd_ applies lr after the "
                       "momentum, not inside it)")
PACK_LIBRARY_NOTE = ("torch.cat(leaves, out=staging): the unpadded pack of "
                     "the main path (no census) in one call; timed only, "
                     "the port never calls it")


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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pack_phase(torch, pool_mod, kpack, shapes, dev, rate, out_lines):
    """pool_pack at the main path's shapes; returns the summary entry."""
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = pool_mod.GradientPool(shapes)
    offs, sizes, n = pool.offsets, pool.sizes, pool.size
    grads = [torch.randn(s, generator=gen, device=dev) for s in sizes]
    params = [torch.randn(s, generator=gen, device=dev) for s in sizes]
    max_err = 0.0
    parts = {}
    # The two packs of every step: grads -> bf16 wire pool (into the
    # staging buffer) and params -> f32 master pool.
    for label, leaves, wire, esize in (
            ("grads_to_bf16", grads, torch.bfloat16, 6),
            ("params_to_f32", params, torch.float32, 8)):
        staging = torch.full((n,), 7.0, dtype=wire, device=dev)
        got, _ = kpack.launch(leaves, offs, sizes, n, 0, wire, out=staging)
        want, _ = kpack.plain(leaves, offs, sizes, n, 0, wire)
        torch.cuda.synchronize()
        check(got.data_ptr() == staging.data_ptr(), "pack ignored staging")
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"pool_pack {label}: kernel != plain "
              f"(max abs diff {err})")
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: kpack.launch(leaves, offs, sizes, n, 0,
                                                 wire, out=staging))
        plain_ms = time_ms(torch, lambda: kpack.plain(leaves, offs, sizes, n,
                                                      0, wire))
        # The library yardstick: on the main path's table (pad_to=1, no
        # padding) one torch.cat into the staging buffer is the same pack.
        check(pool.padding == 0, "main-path pool has padding")
        lib = torch.full((n,), 7.0, dtype=wire, device=dev)
        torch.cat(leaves, out=lib)
        torch.cuda.synchronize()
        check(torch.equal(lib, want), f"torch.cat {label} != plain pack")
        library_ms = time_ms(torch, lambda: torch.cat(leaves, out=lib))
        b_ms, b_by = bound_ms(n * esize, n, rate)
        parts[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=b_ms, bound_by=b_by, bytes=n * esize)
        del got, want, staging, lib
    # The padded table with the chunk census (the CSC/quantized-wire form).
    padded = pool_mod.GradientPool(shapes, pad_to=CHUNK)
    got, norms = kpack.launch(grads, padded.offsets, padded.sizes,
                              padded.size, CHUNK, torch.bfloat16)
    want, want_n = kpack.plain(grads, padded.offsets, padded.sizes,
                               padded.size, CHUNK, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "pool_pack census pool: kernel != plain")
    rel = ((norms - want_n).abs() / want_n.abs().clamp_min(1e-30)).max()
    census_rel = rel.item()
    check(census_rel <= 1e-6, f"pool_pack census rel err {census_rel}")
    ms_census = time_ms(torch, lambda: kpack.launch(
        grads, padded.offsets, padded.sizes, padded.size, CHUNK,
        torch.bfloat16))
    del got, want, norms, want_n, grads, params
    torch.cuda.empty_cache()
    entry = dict(
        name="pool_pack", route="cuda",
        source="src/repro_torch/kernels/csrc/pool_pack.cu",
        replaces="src/repro/kernels/pool_pack.py:134",
        launches=None, max_abs_err=max_err,
        ms=sum(p["ms"] for p in parts.values()),
        plain_ms=sum(p["plain_ms"] for p in parts.values()),
        bound_ms=sum(p["bound_ms"] for p in parts.values()),
        bound_by="bytes",
        library_ms=sum(p["library_ms"] for p in parts.values()),
        library_note=PACK_LIBRARY_NOTE, ported=True,
        per_step_work="grads->bf16 pack + params->f32 pack",
        parts=parts, census_ms=ms_census, census_max_rel_err=census_rel)
    out_lines.append(dict(kernel="pool_pack", ms=entry["ms"],
                          plain_ms=entry["plain_ms"],
                          bound_ms=entry["bound_ms"],
                          library_ms=entry["library_ms"],
                          launches_per_step=2, max_abs_diff=max_err,
                          census_max_rel_diff=census_rel, parts=parts))
    return entry


def update_phase(torch, pool_mod, kunpack, shapes, dev, rate, out_lines):
    """pool_unpack_update over the 6 buckets of one step."""
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = pool_mod.GradientPool(shapes)
    n = pool.size
    views = [pool.bucket_view(s, e)
             for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
    check(len(views) == 6, f"{len(views)} buckets, expected 6")
    master = torch.randn(n, generator=gen, device=dev)
    grads = torch.randn(n, generator=gen, device=dev) * 1e-2
    mom = torch.randn(n, generator=gen, device=dev) * 1e-2
    mask = torch.ones(n, dtype=torch.bool, device=dev)  # lazy: all true
    lr = torch.tensor(0.2, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, weight_decay=1e-4)

    def outputs():
        leaves = [torch.empty(s, device=dev) for s in pool.sizes]
        return leaves, torch.empty(n, device=dev)

    k_leaves, k_mom = outputs()
    p_leaves, p_mom = outputs()

    def step(fn, leaves, mom_out, masks=mask):
        for v in views:
            s, e = v.start, v.end
            fn(master[s:e], grads[s:e], mom[s:e], masks[s:e], v.offsets,
               v.sizes, out_leaves=leaves[v.leaf_lo:v.leaf_hi],
               out_momentum=mom_out[s:e], **kw)

    max_err = 0.0
    rand_mask = torch.rand(n, generator=gen, device=dev) < 0.7
    ratios = torch.rand(pool.num_tensors, generator=gen, device=dev)
    for masks, label in ((mask, "all-true mask"), (rand_mask, "random mask")):
        step(kunpack.launch, k_leaves, k_mom, masks)
        step(kunpack.plain, p_leaves, p_mom, masks)
        torch.cuda.synchronize()
        for a, b in zip(k_leaves + [k_mom], p_leaves + [p_mom]):
            err = (a - b).abs().max().item()
            max_err = max(max_err, err)
            check(torch.equal(a, b), f"pool_unpack_update ({label}): kernel"
                  f" != plain (max abs diff {err})")
    # Per-tensor ratios on one bucket (off the main path; coverage only).
    v = views[0]
    r = ratios[v.leaf_lo:v.leaf_hi]
    a = kunpack.launch(master[:v.size], grads[:v.size], mom[:v.size],
                       rand_mask[:v.size], v.offsets, v.sizes, ratios=r, **kw)
    b = kunpack.plain(master[:v.size], grads[:v.size], mom[:v.size],
                      rand_mask[:v.size], v.offsets, v.sizes, ratios=r, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a[0] + [a[1]], b[0] + [b[1]])),
          "pool_unpack_update with ratios: kernel != plain")
    ms = time_ms(torch, lambda: step(kunpack.launch, k_leaves, k_mom))
    plain_ms = time_ms(torch, lambda: step(kunpack.plain, p_leaves, p_mom))
    b_ms, b_by = bound_ms(n * 21, n * 7, rate)
    del master, grads, mom, mask, k_leaves, k_mom, p_leaves, p_mom
    torch.cuda.empty_cache()
    entry = dict(
        name="pool_unpack_update", route="cuda",
        source="src/repro_torch/kernels/csrc/pool_unpack.cu",
        replaces="src/repro/kernels/pool_unpack.py:132",
        launches=None, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note=UPDATE_LIBRARY_NOTE, ported=True,
        per_step_work="6 bucket launches (theta = 4 Mi elements)")
    out_lines.append(dict(kernel="pool_unpack_update", ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, library_ms=None,
                          launches_per_step=6, max_abs_diff=max_err))
    return entry


def _check_counts(counts, steps):
    want = {"pool_pack.kernel": 2 * steps,
            "pool_unpack_update.kernel": 6 * steps}
    check(counts == want, f"dispatch counts {counts}, expected {want}")


def train_phase(torch, dist, ops, train_mod, synthetic):
    """Two runs of the full-width step in a world-size-1 NCCL group.

    (a) The CLI's loop (``train.train``) on the synthetic stream: the step
        time, finite losses, the kernels' dispatch counts.
    (b) The Trainer the CLI builds, six steps on ONE batch: the loss must
        fall. On a fresh batch each step, six SGD steps at the CLI's
        learning rate move the loss less than the batch-to-batch spread,
        so (a) cannot show learning in six steps; a repeated batch can.
    """
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        args = train_mod.parse_args([
            "--arch", "smollm-135m", "--gf-mode", "lazy", "--use-kernels",
            "--bucket-elems", str(BUCKET_ELEMS), "--batch", str(BATCH),
            "--seq-len", str(SEQ), "--steps", str(STEPS), "--log-every",
            "1"])
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        _, losses, seconds = train_mod.train(args)
        counts = dict(ops.dispatch_counts)
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(x) for x in losses),
              f"non-finite loss {losses}")
        _check_counts(counts, STEPS)

        trainer, cfg = train_mod.build(args)
        state = trainer.init_state(args.seed)
        step = trainer.build_train_step()
        batch = synthetic.SyntheticLM(cfg.model.vocab_size,
                                      seed=args.seed).batch(0, BATCH, SEQ)
        ops.reset_counts()
        fixed = []
        for _ in range(STEPS):
            state, metrics = step(state, batch)
            fixed.append(float(metrics["loss"]))
        _check_counts(dict(ops.dispatch_counts), STEPS)
        del state, step, trainer
    finally:
        dist.destroy_process_group()
    print(f"one batch, repeated: losses {fixed}", flush=True)
    check(all(math.isfinite(x) for x in fixed), f"non-finite loss {fixed}")
    check(fixed[-1] < fixed[0], f"loss did not fall on one batch: {fixed}")
    step_ms = statistics.median(seconds[1:]) * 1e3
    return dict(losses=losses, repeated_batch_losses=fixed, step_ms=step_ms,
                first_step_ms=seconds[0] * 1e3,
                tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
                peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts)


NOT_PORTED = [
    dict(name="fused_update", replaces="src/repro/kernels/fused_update.py:73",
         ported=False),
    dict(name="ring_allreduce", replaces="src/repro/kernels/ring_reduce.py:302",
         ported=False),
    dict(name="chunk_l1norm", replaces="src/repro/kernels/chunk_l1norm.py:50",
         ported=False),
    dict(name="csc_compact", replaces="src/repro/kernels/csc_compact.py:39",
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
    from repro_torch.core import pool as pool_mod
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pool_pack as kpack
    from repro_torch.kernels import pool_unpack as kunpack
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
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
    lines: list = []
    entries = [pack_phase(torch, pool_mod, kpack, shapes, dev, rate, lines),
               update_phase(torch, pool_mod, kunpack, shapes, dev, rate,
                            lines)]
    for line in lines:
        line.update(gpu=name, power_limit=smi_line.split(",")[-1].strip())
        print(json.dumps(line), flush=True)

    result = train_phase(torch, dist, ops, train_mod, synthetic)
    print(json.dumps(dict(train="smollm-135m", batch=BATCH, seq_len=SEQ,
                          steps=STEPS, gpu=name,
                          power_limit=smi_line.split(",")[-1].strip(),
                          **result)), flush=True)
    entries[0]["launches"] = result["dispatch_counts"]["pool_pack.kernel"]
    entries[1]["launches"] = \
        result["dispatch_counts"]["pool_unpack_update.kernel"]
    print(smi_line)
    print(json.dumps({"kernels": entries, "not_ported": NOT_PORTED,
                      "gpu": name, "nvidia_smi": smi_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

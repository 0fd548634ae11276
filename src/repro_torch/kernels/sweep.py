"""Time the CSC kernels' launch plans, and a launch's host cost, on one
CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.sweep [--out FILE]

On the smollm-135m CSC pool (4106 chunks of 32,768 f32), for each plan
variant (stages, stage bytes, CTAs an SM) of ``csc_compact`` at k = 616
and 3233 and of ``chunk_l1norm``: the device time of a launch back to
back (B2B launches in one CUDA-event region, divided by B2B; median of
REPS regions), each checked against the plain version first, beside
``torch.index_select`` and ``torch.linalg.vector_norm`` timed the same way
in the same process. Then the host time of one launch (the mean over B2B
launches enqueued back to back, the device running behind), split into
the wrapper's parts: ``torch.empty`` of the output, the plan and the
stream, and the C launch through ctypes. Prints one JSON line a variant
and one for the host split; exits non-zero without a card or on a wrong
result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels import chunk_l1norm as kcl
from repro_torch.kernels import csc_compact as kcc

CHUNK, NUM_CHUNKS, KS = 32768, 4106, (616, 3233)
REPS, WARMUP, B2B = 20, 3, 20
COMPACT_VARIANTS = [  # (stages, stage bytes, CTAs an SM)
    (12, 16384, 1), (6, 32768, 1), (24, 8192, 1), (6, 16384, 2),
    (3, 32768, 2), (48, 4096, 1)]
CENSUS_VARIANTS = [(6, 1), (4, 1), (3, 2)]  # (stages, CTAs an SM)


def back_to_back_ms(fn) -> float:
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


def host_ms(fn) -> float:
    """Mean host time of one call over B2B calls in a row (median of
    REPS), the device left to run behind."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(B2B):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / B2B)
        torch.cuda.synchronize()
    return statistics.median(times)


def _set(mod, **consts) -> None:
    for name, value in consts.items():
        setattr(mod, name, value)
    mod.plan.cache_clear()
    mod.launch_words.cache_clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = torch.randn(NUM_CHUNKS * CHUNK, generator=gen, device=dev)
    rows = pool.view(NUM_CHUNKS, CHUNK)
    idx = {k: torch.sort(torch.randperm(NUM_CHUNKS, generator=gen,
                                        device=dev)[:k]).values for k in KS}
    lines = []

    def emit(d):
        d.update(gpu=card)
        lines.append(json.dumps(d))
        print(lines[-1], flush=True)

    defaults = dict(compact=dict(STAGES=kcc.STAGES, STAGE_BYTES=kcc.
                                 STAGE_BYTES, CTAS_PER_SM=kcc.CTAS_PER_SM),
                    census=dict(STAGES=kcl.STAGES,
                                CTAS_PER_SM=kcl.CTAS_PER_SM))
    library = {f"index_select k={k}": back_to_back_ms(
        lambda k=k: torch.index_select(rows, 0, idx[k])) for k in KS}
    library["vector_norm"] = back_to_back_ms(
        lambda: torch.linalg.vector_norm(rows, ord=1, dim=1))
    for stages, stage, ctas in COMPACT_VARIANTS:
        _set(kcc, STAGES=stages, STAGE_BYTES=stage, CTAS_PER_SM=ctas)
        ms = {}
        for k in KS:
            got = kcc.launch(pool, idx[k], CHUNK)
            if not torch.equal(got, kcc.plain(pool, idx[k], CHUNK)):
                sys.exit(f"csc_compact {stages}x{stage}x{ctas}: wrong")
            ms[f"k={k}"] = back_to_back_ms(
                lambda k=k: kcc.launch(pool, idx[k], CHUNK))
        emit(dict(kernel="csc_compact", stages=stages, stage_bytes=stage,
                  ctas_per_sm=ctas, back_to_back_ms=ms))
    _set(kcc, **defaults["compact"])
    want = kcl.plain(pool, CHUNK)
    first = None
    for stages, ctas in CENSUS_VARIANTS:
        _set(kcl, STAGES=stages, CTAS_PER_SM=ctas)
        got = kcl.launch(pool, CHUNK)
        first = got if first is None else first
        rel = ((got - want).abs() / want.abs()).max().item()
        if rel > 1e-6 or not torch.equal(got, first):
            sys.exit(f"chunk_l1norm {stages}x{ctas}: rel err {rel}")
        emit(dict(kernel="chunk_l1norm", stages=stages, ctas_per_sm=ctas,
                  back_to_back_ms=back_to_back_ms(
                      lambda: kcl.launch(pool, CHUNK))))
    _set(kcl, **defaults["census"])
    emit(dict(library_back_to_back_ms=library))

    # The host's part of one launch of the gather at k = 616.
    k, ids = KS[0], idx[KS[0]]
    out = kcc.launch(pool, ids, CHUNK)
    plan_args = (k, NUM_CHUNKS, CHUNK * 4, 4, 16, kcc._sms(0), None)
    c_args = (pool.data_ptr(), ids.data_ptr(), out.data_ptr(),
              kcc.launch_words(*plan_args), build.current_stream(0))
    fn = kcc._lib()
    emit(dict(host_ms={
        "csc_compact.launch": host_ms(lambda: kcc.launch(pool, ids, CHUNK)),
        "torch.empty": host_ms(lambda: torch.empty(
            (k * CHUNK,), dtype=pool.dtype, device=dev)),
        "plan + device + stream": host_ms(lambda: (
            kcc.launch_words(k, NUM_CHUNKS, CHUNK * 4, 4, build.base_align(
                pool.data_ptr(), out.data_ptr()), kcc._sms(0), None),
            torch.cuda.current_device(), build.current_stream(0))),
        "out.new_empty": host_ms(lambda: pool.new_empty(k * CHUNK)),
        "C launch (ctypes)": host_ms(lambda: fn(*c_args)),
        "torch.index_select": host_ms(lambda: torch.index_select(
            rows, 0, ids)),
        "chunk_l1norm.launch": host_ms(lambda: kcl.launch(pool, CHUNK)),
        "torch.linalg.vector_norm": host_ms(
            lambda: torch.linalg.vector_norm(rows, ord=1, dim=1))}))
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

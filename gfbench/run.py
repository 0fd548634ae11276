"""Run one cell of the benchmark once and print its result as the last
line of standard output:

  python3 gfbench/run.py --workload olmo1b-train --seed 7 --seconds 30 \\
      --trace 0

The cell is found by name in BENCHMARK.json and its files under
``gfbench/``. ``--trace 0`` reports the cell's end-to-end metrics from a
measured window of ``--seconds``; ``--trace 1`` its per-layer metrics
from a short profiled stretch. Every run checks the program's first
steps against the plain reference and prints each number compared with
its limit, on standard error and last in the result's line. A cell on
several chips runs one process a card, launched here; rank 0 prints.

Exits non-zero without a result when CUDA has fewer cards than the cell
asks for, and when the process holds ``jax``, ``jaxlib``, ``flax`` or
``repro`` once the run is over.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CACHE = ROOT / ".gfbench_cache"


def forbidden_modules():
    """The top-level names of loaded modules that the run must not hold,
    each compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by the launcher of a cell on several chips.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    # Kernel caches at fixed places inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from gfbench.harness import launch, spec, training

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gfbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        code, out = launch.spawn(str(Path(__file__).resolve()), argv,
                                 cell.chips, T0)
        if code:
            return code
        # Rank 0's result, printed here once every rank has ended.
        result = json.loads(out.strip().splitlines()[-1])
    else:
        rank, world = args.rank or 0, cell.chips
        device = torch.device("cuda", rank)
        launch.join(rank, world, args.port, device)
        from repro_torch.kernels import build
        build.build_all()
        result, _, _ = training.run(cell, args.seed, args.seconds,
                                    bool(args.trace), device,
                                    args.t0 if args.t0 is not None else T0,
                                    rank, world)
        launch.leave(world)
    bad = forbidden_modules()
    if bad:
        print(f"gfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.rank in (None, 0):
        emit(result)
    return 0


def emit(result) -> None:
    """The numbers compared beside their limits, as the last lines of
    standard error, and the result as the last line of standard output."""
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from: the program's (with
``--program``, the checked steps of a run without its window) and those
of the control and the planted faults, each put in the program's place
and compared with the plain reference by the numbers a run compares.

  python3 gfbench/controls.py --workload olmo1b-train --seeds 1 2 3 \\
      --variants fp8 half_batch --program

Variants (each the reference's checked steps on the cell's own rows; with
``--variant-seeds n`` on the first n seeds alone):

* ``fp8``: the control, every product one precision below the
  configuration's bfloat16 (float8 e4m3 operands, a scale a tensor);
* ``half_batch``: the gradient and the loss over the first half of each
  rank's rows, the mean taken over them;
* ``no_exchange``: (several ranks) each rank's gradient left out of the
  exchange, its own divided by the ranks as if summed;
* ``f32``: the reference with its products in float32, TF32 off, against
  a cell's TF32 reference: the reference's own rounding.

A state left unchanged reads 1 by ``update_gap`` and needs no run. One
JSON line a seed on standard output (rank 0).
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("fp8", "half_batch", "no_exchange", "f32")


def variant_args(name: str, rows: int):
    return {"fp8": {"precision": "fp8"},
            "half_batch": {"rows": slice(0, rows // 2)},
            "no_exchange": {"exchange": False},
            "f32": {"matmul": "exact"}}[name]


def readings(cell, seed: int, variants, device, rank: int, world: int,
             program: bool = False):
    """The gaps of each variant (and with ``program`` the program's) to
    the reference on ``seed``."""
    from gfbench.harness import check, training, weights

    wl, conf = cell.workload, cell.config
    specs = cell.reference.param_shapes(conf)
    std = conf["initializer_range"]
    K = wl["trainer"]["window_steps"]
    batches = training.batches(cell, seed, rank, 0, check.checked_steps(K))

    def side(**kw):
        kw = {"matmul": wl.get("reference_matmul", "exact"), **kw}
        return check.reference_readings(
            cell.reference, conf, wl["gradientflow"], wl["optimizer"], specs,
            lambda n: weights.draw(specs, n, seed, std, device), batches,
            world, device, wl["reference_rows"], K, **kw)

    out = {"seed": seed}
    t = time.time()
    if program:
        result, _, ref = training.run(cell, seed, 0.0, False, device, t,
                                      rank, world, window=False)
        out["program"] = {k: v["value"] for k, v in result["check"].items()}
        out["program_s"] = result["metrics"]["setup_s"]["value"]
    else:
        ref = side()
    out["reference_losses"] = ref.losses
    out["first_s"] = time.time() - t
    for v in variants:
        out[v] = check.gaps(side(**variant_args(v, cell.rows)), ref,
                            check.numbers(K))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="gfbench/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="*", choices=VARIANTS,
                   default=["fp8", "half_batch"])
    p.add_argument("--variant-seeds", type=int, default=None,
                   help="run the variants on the first n seeds alone")
    p.add_argument("--program", action="store_true",
                   help="also read the program's numbers on every seed")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from gfbench.harness import launch, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"gfbench: {cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        code, out = launch.spawn(str(Path(__file__).resolve()), argv,
                                 cell.chips, T0)
        print(out, end="", flush=True)
        return code
    rank, world = args.rank or 0, cell.chips
    device = torch.device("cuda", rank)
    launch.join(rank, world, args.port, device)
    n = len(args.seeds) if args.variant_seeds is None else args.variant_seeds
    for i, seed in enumerate(args.seeds):
        t = time.time()
        line = readings(cell, seed, args.variants if i < n else [], device,
                        rank, world, args.program)
        line["seconds"] = time.time() - t
        if rank == 0:
            print(json.dumps(line), flush=True)
    launch.leave(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())

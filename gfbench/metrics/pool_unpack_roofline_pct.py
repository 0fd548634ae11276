"""The unpack-update's share of its roofline: the least time its bytes
need at the card's memory bandwidth (every input byte read once, every
output byte written once, over the whole pool, from the pool's shapes)
over its measured device time, a step."""

from gfbench.harness import profile
from gfbench.yardstick import bytes as ybytes
from gfbench.yardstick import peaks

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    s = profile.kernel_seconds(run.trace, lambda n: "pool_unpack" in n)
    if s <= 0:
        return None
    gf, shapes = run.cell.workload["gradientflow"], run.cell.shapes
    pad = gf["chunk_elems"] if gf["mode"] == "csc" else 1
    least = ybytes.unpack_update_bytes(
        ybytes.pool_elems(shapes), ybytes.pool_elems(shapes, pad)) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * least * run.trace.steps / s

"""The ring all-reduce's share of its roofline: the least time of a
step's all-reduces, the larger of their device-memory bytes at the
card's bandwidth and their link bytes (2(N-1)/N of each message, sent
each way) at NVLink's, over the ring kernels' measured device time. The
bytes come from the elements the step sends (CSC's kept chunks) in the
wire dtype, whatever implements the all-reduce."""

from gfbench.harness import profile
from gfbench.yardstick import bytes as ybytes
from gfbench.yardstick import peaks

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "train_tokens_per_s"
WIRE_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    if run.trace is None or run.world < 2:
        return None
    s = profile.kernel_seconds(run.trace,
                               lambda n: profile.RING_KERNEL in n)
    if s <= 0:
        return None
    gf = run.cell.workload["gradientflow"]
    w = WIRE_ITEMSIZE[gf["wire_dtype"]]
    n, ranks = ybytes.sent_elems(run.cell.shapes, gf), run.world
    least = max(ybytes.ring_hbm_bytes(n, ranks, w, w)
                / peaks.HBM_BYTES_PER_S,
                ybytes.ring_link_bytes(n, ranks, w)
                / peaks.NVLINK_BYTES_PER_S)
    return 100.0 * least * run.trace.steps / s

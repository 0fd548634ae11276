"""The flash-attention kernels' share of their roofline: the least time
of attention's products a step (``yardstick/attention.py``: the pairs
each layer's mask keeps, windowed on sliding layers, at the card's dense
bf16 peak) over the device time of the ``flash_attn`` kernels a step."""

from gfbench.harness import profile
from gfbench.yardstick import attention, peaks

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    s = profile.kernel_seconds(run.trace, lambda n: "flash_attn" in n)
    if s <= 0:
        return None
    cell = run.cell
    flops = attention.step_flops(
        cell.config, cell.rows, cell.seq_len,
        cell.workload["trainer"]["remat"] == "layer")
    return 100.0 * flops * run.trace.steps / peaks.BF16_FLOPS / s

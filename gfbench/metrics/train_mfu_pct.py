"""The whole step's share of the card's peak: the model FLOPs of the
traced steps (the frozen count: 6 a weight a token and the causal half
of attention, no recompute) over the traced stretch's time, over the
dense bf16 peak of 989 TFLOP/s. The card's power limit is in the
result's ``device``."""

from gfbench.yardstick import flops as yflops
from gfbench.yardstick import peaks

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    cell = run.cell
    flops = yflops.step_flops(cell.config, cell.shapes, cell.rows,
                              cell.seq_len) * run.trace.steps
    return 100.0 * flops / run.trace.window_s / peaks.BF16_FLOPS

"""The experts' grouped GEMM's share of its roofline: the FLOPs its
products need a step (``yardstick/moe.py``, from the rows the held
experts computed, the program's ``moe`` tally) at the card's dense bf16
peak, over the device time of the ``moe_gmm`` kernels a step. Nothing
without those kernels or that tally."""

from gfbench.harness import profile, program
from gfbench.yardstick import moe, peaks

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    s = profile.kernel_seconds(run.trace, lambda n: "moe_gmm" in n)
    rows = program.per_step("moe", "rows")
    if s <= 0 or not rows:
        return None
    conf = run.cell.config
    flops = moe.step_flops(rows, conf["hidden_size"],
                           conf["moe_intermediate_size"],
                           run.cell.workload["trainer"]["remat"] == "layer")
    return 100.0 * flops * run.trace.steps / peaks.BF16_FLOPS / s

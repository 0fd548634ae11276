"""Device milliseconds a step in the model's forward and backward: every
kernel that is neither one of the port's six kernels nor a collective."""

from gfbench.harness import profile

LAYER = "models"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    s = profile.kernel_seconds(run.trace, profile.is_model)
    return s / run.trace.steps * 1e3

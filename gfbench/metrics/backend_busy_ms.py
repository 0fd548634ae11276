"""Device milliseconds a step in the backend's kernels: the packs, the
unpack-update (the optimizer runs inside it), the chunk census and the
CSC gather, by kernel name."""

from gfbench.harness import profile

LAYER = "core"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    s = profile.kernel_seconds(run.trace, profile.is_backend)
    return s / run.trace.steps * 1e3 if s > 0 else None

"""The share of the traced stretch, on rank 0's card, in which no kernel,
copy or fill runs."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

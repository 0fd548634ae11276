"""The device memory the run's tensors held at their peak, over set-up and
the window (``torch.cuda.max_memory_allocated``), the largest over the
ranks, in GiB: what decides whether a model and batch fit."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

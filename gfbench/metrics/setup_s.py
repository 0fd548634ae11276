"""Seconds from the process's start to the first measured step: imports,
the kernels loaded from their build cache, the weights drawn, the
trainer and its state, the first steps, and a window's capture."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s

"""Megabytes a step handed to the data group's collectives, in the dtype
each travels in (the program's ``comm`` counter ``bytes``, counted once
a collective), over the traced stretch's calls: CSC's kept chunks, the
census sum and the metrics' sums."""

from gfbench.harness import program

LAYER = "parallel"
UNIT, BETTER, SOURCE, MOVES = "MB", "lower", "program_counter", \
    "train_tokens_per_s"


def read(run):
    if run.world < 2:
        return None
    b = program.per_step("comm", "bytes")
    return b / 1e6 if b is not None else None

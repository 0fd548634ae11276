"""Collectives of the data group a step (the program's ``comm`` counter
``calls``, once a collective), over the traced stretch's calls: one a
bucket, the census sum, the metrics' sums spread over a window's
steps."""

from gfbench.harness import program

LAYER = "parallel"
UNIT, BETTER, SOURCE, MOVES = "calls", "lower", "program_counter", \
    "train_tokens_per_s"


def read(run):
    if run.world < 2:
        return None
    return program.per_step("comm", "calls")

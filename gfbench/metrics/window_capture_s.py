"""Host seconds of the window's set-up: the warm-up body and the CUDA
graph's capture, as the program's ``launch`` counters took them
(``warmup_s`` + ``capture_s``, the host time of its ``launch.warmup``
and ``launch.capture`` spans). Nothing when no graph was captured."""

from gfbench.harness import program

LAYER = "launch"
UNIT, BETTER, SOURCE, MOVES = "s", "lower", "program_span", "setup_s"


def read(run):
    c = program.counters()
    if c is None or not c["launch"]["capture_s"]:
        return None
    return c["launch"]["warmup_s"] + c["launch"]["capture_s"]

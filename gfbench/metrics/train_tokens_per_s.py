"""Tokens trained a second: every token of the whole steps that completed
inside the measured window, summed over the ranks, over the time from
the window's start to the end of the last of them (host clock, each
call's losses read before the next). One frame position of an audio
model counts as one token."""

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    if run.window_s <= 0:
        return None
    return run.tokens / run.window_s

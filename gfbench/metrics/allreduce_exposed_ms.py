"""Device milliseconds a step of the collectives (the port's ring, NCCL)
that no other kernel overlaps: the exchange the step waits for."""

from gfbench.harness import profile

LAYER = "parallel"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", \
    "train_tokens_per_s"


def read(run):
    if run.trace is None or run.world < 2:
        return None
    comm = profile.union([(e.start, e.end)
                          for e in run.trace.kernels(profile.is_comm)])
    if not comm:
        return None
    rest = profile.union([(e.start, e.end) for e in run.trace.kernels(
        lambda n: not profile.is_comm(n))])
    exposed = profile.measure(profile.minus(comm, rest))
    return exposed / run.trace.steps * 1e3

"""Device milliseconds a step, on this rank's card (rank 0's is
printed), in which no kernel, copy or fill runs while the host
dispatches one of the program's training calls: inside the union of its
``launch.call`` spans and outside its ``launch.replay`` spans. A replay
hands the card a whole CUDA graph at once, so the card's gaps while the
host waits in it are the graph's own node-to-node gaps
(``device_idle_pct`` counts them), not the host holding the card back.
0 when the card never idles there; nothing when the trace holds no
call."""

from gfbench.harness import profile

LAYER = "launch"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", \
    "train_tokens_per_s"
CALL, REPLAY = "launch.call", "launch.replay"


def read(run):
    if run.trace is None:
        return None
    t = run.trace

    def spans(name):
        return profile.union([(e.start, e.end) for e in t.host
                              if e.kind == "user_annotation"
                              and e.name == name])

    calls = spans(CALL)
    if not calls:
        return None
    idle = profile.minus([t.span], profile.union(
        [(e.start, e.end) for e in t.device]))
    outside = profile.minus([t.span],
                            profile.minus(calls, spans(REPLAY)))
    return profile.measure(profile.minus(idle, outside)) / t.steps * 1e3

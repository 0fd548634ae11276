"""Runtime of the port: data-plane fault injection (``runtime.faults``)
for the numeric guard rail. Checkpoints, elasticity and the soak are not
ported yet (ROADMAP.md A.15)."""

"""Runtime of the port: checkpoint/restart supervision
(``fault_tolerance``), straggler detection, the elastic controller, and
data-plane fault injection for the numeric guard rail (``faults``). The
JAX package's elastic soak (``repro/runtime/soak.py``) is not ported yet
(ROADMAP.md A.16)."""
from repro_torch.runtime.elastic import ElasticController, candidates_for
from repro_torch.runtime.fault_tolerance import (Preempted, SupervisorConfig,
                                                 TrainSupervisor)
from repro_torch.runtime.stragglers import StragglerDetector, StragglerReport

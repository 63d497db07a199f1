"""The paper's contribution: dynamic distributed scheduling (DDS), copied
from ``repro.core`` with only its import paths changed (the profile's
chunk-cost fit apart): policies, profiles, the latency predictor,
admission, telemetry, the live ``Fleet`` of ``Worker``s over ``Link``s,
and the discrete-event simulator."""
from repro_torch.core.admission import admit, min_feasible_ms               # noqa: F401
from repro_torch.core.latency import (NodeState, Task, predict_process_ms,  # noqa: F401
                                      predict_queue_ms, predict_total_ms,
                                      slack_ms)
from repro_torch.core.node import Completion, Worker, certify               # noqa: F401
from repro_torch.core.policies import (AOE, AOR, DDS, DDS_EDF, DDS_P2C,     # noqa: F401
                                       EODS, JSQ, NodeView, Policy,
                                       make_policy)
from repro_torch.core.profile import (AppProfile, Curve, DeviceProfile,     # noqa: F401
                                      FACE, LinkProfile, measure_profile,
                                      paper_edge_server, paper_raspberry_pi)
from repro_torch.core.scheduler import Fleet, FleetStats                    # noqa: F401
from repro_torch.core.simulator import (SimConfig, SimResult, Simulator,    # noqa: F401
                                        TaskRecord, run_sim)
from repro_torch.core.telemetry import (MaintainProfileTable,               # noqa: F401
                                        UpdateProfilePublisher)

"""The paper's scheduler pieces the serving fleet needs (DDS policies,
profiles, latency predictor, admission, telemetry), copied from
``repro.core`` with only their import paths changed.  The simulator, the
``Fleet`` of simulated workers and the network model are not part of this
slice of the port."""
from repro_torch.core.admission import admit, min_feasible_ms               # noqa: F401
from repro_torch.core.latency import (NodeState, Task, predict_process_ms,  # noqa: F401
                                      predict_queue_ms, predict_total_ms,
                                      slack_ms)
from repro_torch.core.policies import (AOE, AOR, DDS, DDS_EDF, DDS_P2C,     # noqa: F401
                                       EODS, JSQ, NodeView, Policy,
                                       make_policy)
from repro_torch.core.profile import (AppProfile, Curve, DeviceProfile,     # noqa: F401
                                      LinkProfile)
from repro_torch.core.telemetry import (MaintainProfileTable,               # noqa: F401
                                        UpdateProfilePublisher)

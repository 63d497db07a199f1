"""Deadline admission control.

Paper insight: "It is important to set the minimum time constraint required
for all requests.  If the time constraint is too short, none of the
scheduling algorithms can improve performance … any application requests
with a time constraint less than this time should be rejected."

The feasibility floor for a task is the best-case T_task across the fleet:
idle-node processing plus (for remote nodes) transfer both ways.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.core.latency import NodeState, Task, predict_total_ms
from repro_torch.core.profile import DeviceProfile


def min_feasible_ms(fleet: Dict[str, DeviceProfile], task: Task,
                    source: str) -> float:
    best = float("inf")
    idle = NodeState()
    for name, prof in fleet.items():
        t = predict_total_ms(prof, task, idle, remote=name != source)
        best = min(best, t)
    return best


def admit(fleet: Dict[str, DeviceProfile], task: Task, source: str,
          margin: float = 1.0) -> Tuple[bool, float]:
    """Returns (admitted, floor_ms).  ``margin`` scales the floor (e.g. 1.2
    keeps 20% headroom for queueing/staleness).

    An empty (or profile-less) fleet has no floor to measure: admit and
    let routing report the membership problem — admission only rejects
    tasks *proven* infeasible."""
    floor = min_feasible_ms(fleet, task, source)
    if not math.isfinite(floor):
        return True, floor
    return task.constraint_ms >= floor * margin, floor

"""Scheduling policies.

Paper policies:
  * AOR  — All On the Raspberry Pi (source device) — baseline 1
  * AOE  — All On the Edge server — baseline 2
  * EODS — Even/Odd static Distributed Scheduling — baseline 3
  * DDS  — the paper's Dynamic Distributed Scheduler:
             rule 1: run locally iff the local node can meet the deadline
                     (minimizes runtime scheduling communication);
             rule 2: the coordinator offloads to a capable peer with a free
                     warm slot (keeping itself lightly loaded), else runs
                     the task itself.

Beyond-paper policies (ours — recorded separately in EXPERIMENTS.md):
  * DDS_EDF  — DDS + deadline-ordered (EDF) node queues + drop-late
  * DDS_P2C  — coordinator uses power-of-two-choices among peers+self
  * JSQ      — coordinator joins the shortest (stale-view) queue

Every decision goes through the paper's T_task predictor over possibly-stale
``NodeState`` views — the staleness tolerance is the design point.  The
predictor itself is profile-driven: process-per-slot devices use the
measured contention curve (Tables V/VI), while batched serving replicas
carry lane-mode profiles (measured per-occupancy ``decode_step`` cadence),
so DDS does not over-penalize a busy-but-sub-linear batched replica.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.latency import NodeState, Task, predict_total_ms, slack_ms
from repro_torch.core.profile import DeviceProfile

LOCAL = "local"
FORWARD = "forward"


@dataclass
class NodeView:
    """What a decision-maker knows about one node."""

    profile: DeviceProfile
    state: NodeState
    free_slots: int


class Policy:
    name = "base"
    # queue discipline the nodes should use under this policy
    queue_discipline = "fifo"           # fifo | edf
    drop_late = False                   # drop queued tasks already past deadline

    def decide_source(self, task: Task, now: float, local: NodeView) -> str:
        raise NotImplementedError

    def decide_coordinator(self, task: Task, now: float, coord: NodeView,
                           peers: Dict[str, NodeView]) -> str:
        """Return node name to run on (coordinator's own name = run local)."""
        raise NotImplementedError


class AOR(Policy):
    name = "AOR"

    def decide_source(self, task, now, local):
        return LOCAL

    def decide_coordinator(self, task, now, coord, peers):
        return coord.profile.device_id


class AOE(Policy):
    name = "AOE"

    def decide_source(self, task, now, local):
        return FORWARD

    def decide_coordinator(self, task, now, coord, peers):
        return coord.profile.device_id


class EODS(Policy):
    name = "EODS"

    def decide_source(self, task, now, local):
        return LOCAL if task.task_id % 2 == 1 else FORWARD

    def decide_coordinator(self, task, now, coord, peers):
        return coord.profile.device_id


class DDS(Policy):
    """The paper's scheduler."""

    name = "DDS"

    def __init__(self, require_free_slot: bool = True):
        # paper: "only offloads the task to that device if containers are
        # available" — mitigates the queue-induced prediction error.  For
        # batched replicas a "slot" is a decode lane, so a busy replica
        # with a free lane stays eligible and its lane-mode profile prices
        # the join at the measured marginal step cost.
        self.require_free_slot = require_free_slot

    def decide_source(self, task, now, local):
        t_local = predict_total_ms(local.profile, task, local.state, remote=False)
        if t_local <= slack_ms(task, now):
            return LOCAL
        return FORWARD

    def decide_coordinator(self, task, now, coord, peers):
        budget = slack_ms(task, now)
        # rule 2: prefer capable end devices to keep the coordinator light
        best, best_t = None, float("inf")
        for name, view in peers.items():
            if self.require_free_slot and view.free_slots <= 0:
                continue
            t = predict_total_ms(view.profile, task, view.state, remote=True)
            if t <= budget and t < best_t:
                best, best_t = name, t
        if best is not None:
            return best
        return coord.profile.device_id


class DDS_EDF(DDS):
    """DDS + earliest-deadline-first node queues + shed already-late work."""

    name = "DDS_EDF"
    queue_discipline = "edf"
    drop_late = True


class DDS_P2C(DDS):
    """Coordinator picks best of two random candidates (peers + itself).
    Cuts decision cost from O(fleet) to O(1) profile lookups — relevant at
    1000-node scale where scanning the full MP table per task is the
    bottleneck."""

    name = "DDS_P2C"

    def __init__(self, seed: int = 0, require_free_slot: bool = True):
        super().__init__(require_free_slot)
        self._rng = random.Random(seed)

    def decide_coordinator(self, task, now, coord, peers):
        budget = slack_ms(task, now)
        names = list(peers.keys()) + [coord.profile.device_id]
        cands = self._rng.sample(names, k=min(2, len(names)))
        best, best_t = coord.profile.device_id, float("inf")
        for name in cands:
            if name == coord.profile.device_id:
                view, remote = coord, False
            else:
                view, remote = peers[name], True
                if self.require_free_slot and view.free_slots <= 0:
                    continue
            t = predict_total_ms(view.profile, task, view.state, remote=remote)
            if t <= budget and t < best_t:
                best, best_t = name, t
        return best


class JSQ(Policy):
    """Join-shortest-queue at the coordinator; source always forwards."""

    name = "JSQ"

    def decide_source(self, task, now, local):
        return FORWARD

    def decide_coordinator(self, task, now, coord, peers):
        best = coord.profile.device_id
        best_q = (coord.state.queued + coord.state.running
                  + coord.state.reserved)
        for name, view in peers.items():
            q = view.state.queued + view.state.running + view.state.reserved
            if q < best_q:
                best, best_q = name, q
        return best


def make_policy(name: str, **kw) -> Policy:
    table = {p.name: p for p in (AOR, AOE, EODS)}
    if name in table:
        return table[name]()
    if name == "DDS":
        return DDS(**kw)
    if name == "DDS_EDF":
        return DDS_EDF(**kw)
    if name == "DDS_P2C":
        return DDS_P2C(**kw)
    if name == "JSQ":
        return JSQ(**kw)
    raise KeyError(name)

"""The live two-level DDS runtime: real workers, real telemetry, any Policy.

Level 1 (source node): decide locally with *exact* local state — zero
scheduling communication when the local node can meet the deadline.
Level 2 (coordinator): decide with the *stale* MP table view; prefer
capable peers (keeps the coordinator light), else run on the coordinator.

This is the same decision logic the simulator exercises, wired to live
``Worker`` threads — and it is the router the serving engine
(`repro_torch.serving.engine`) plugs into.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.admission import admit
from repro_torch.core.latency import NodeState, Task
from repro_torch.core.network import Link
from repro_torch.core.node import Completion, Worker, certify
from repro_torch.core.policies import FORWARD, LOCAL, NodeView, Policy
from repro_torch.core.telemetry import (MaintainProfileTable,
                                        UpdateProfilePublisher)


@dataclass
class FleetStats:
    submitted: int = 0
    rejected: int = 0
    lost: int = 0
    placements: Dict[str, int] = field(default_factory=dict)


class Fleet:
    """A set of live workers under one coordinator + one source node."""

    def __init__(self, policy: Policy, *, source: str, coordinator: str,
                 heartbeat_ms: float = 20.0, admission_margin: float = 0.0,
                 required_apps: Optional[List[str]] = None):
        self.policy = policy
        self.source_name = source
        self.coordinator_name = coordinator
        self.heartbeat_ms = heartbeat_ms
        self.admission_margin = admission_margin
        self.required_apps = required_apps or []
        self.workers: Dict[str, Worker] = {}
        self.links: Dict[str, Link] = {}
        self.table = MaintainProfileTable()
        self._publishers: Dict[str, UpdateProfilePublisher] = {}
        self.stats = FleetStats()
        self._lock = threading.Lock()
        # admission reads the fleet's (static) profiles on every submit;
        # cache the dict and invalidate on membership changes
        self._fleet_profiles: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ lifecycle
    def add_worker(self, worker: Worker, link: Optional[Link] = None) -> None:
        """Certification handshake + join (paper: devices certified before
        joining; fleet port: elastic scale-out entry point)."""
        ok, why = certify(worker.profile, self.required_apps)
        if not ok:
            raise ValueError(f"certification failed for {worker.name}: {why}")
        pub = UpdateProfilePublisher(worker.name, worker.profile,
                                     worker.state, self.table,
                                     self.heartbeat_ms)
        with self._lock:
            self.workers[worker.name] = worker
            self.links[worker.name] = link or Link(worker.profile.link)
            self._publishers[worker.name] = pub
            self._fleet_profiles = None

    def remove_worker(self, name: str) -> None:
        """Elastic scale-in / failure handling: unregister and stop."""
        with self._lock:
            pub = self._publishers.pop(name, None)
            w = self.workers.pop(name, None)
            self.links.pop(name, None)
            self._fleet_profiles = None
        if pub:
            pub.stop()
        if w:
            w.stop()
        self.table.remove(name)

    def start(self) -> None:
        for w in self.workers.values():
            w.start()
        for p in self._publishers.values():
            p.start()

    def stop(self) -> None:
        for p in self._publishers.values():
            p.stop()
        for w in self.workers.values():
            w.stop()

    # ------------------------------------------------------------- routing
    def _view(self, w: Worker, exact: bool) -> NodeView:
        if exact:
            state = w.state()
        else:
            rec = self.table.get(w.name)
            state = rec.state if rec else NodeState()
        free = max(w.profile.slots - state.running - state.queued, 0)
        return NodeView(profile=w.profile, state=state, free_slots=free)

    def _lost(self) -> bool:
        with self._lock:
            self.stats.lost += 1
        return False

    def submit(self, task: Task,
               on_done: Optional[Callable[[Completion], None]] = None) -> bool:
        """Route one task through the two-level scheduler.

        Membership is snapshotted under the lock once, up front: elastic
        scale-in (``remove_worker``) can run mid-submit, and routing must
        never KeyError on a vanished node — a task routed to a node that
        left the fleet is accounted ``lost`` (the same UDP-loss surface the
        paper's source->device sends have), not crashed."""
        now = time.monotonic() * 1e3
        with self._lock:
            self.stats.submitted += 1
            workers = dict(self.workers)
            links = dict(self.links)
            fleet_profiles = self._fleet_profiles
            if fleet_profiles is None:
                fleet_profiles = {n: w.profile for n, w in workers.items()}
                self._fleet_profiles = fleet_profiles
        if self.admission_margin > 0:
            ok, _ = admit(fleet_profiles, task, self.source_name,
                          self.admission_margin)
            if not ok:
                with self._lock:
                    self.stats.rejected += 1
                return False

        # level 1: source-local decision on exact local state
        source = workers.get(self.source_name)
        if source is None:
            return self._lost()          # source itself scaled in
        decision = self.policy.decide_source(
            task, now, self._view(source, exact=True))
        if decision == LOCAL:
            return self._place(task, self.source_name, workers, on_done)

        # forward to coordinator (over the source->coordinator link)
        coordinator = workers.get(self.coordinator_name)
        coord_link = links.get(self.coordinator_name)
        if coordinator is None or coord_link is None:
            return self._lost()
        if not coord_link.send(task.size_kb):
            return self._lost()                    # UDP-style loss

        # level 2: coordinator decision on (stale) MP table views
        peers = {n: self._view(w, exact=False) for n, w in workers.items()
                 if n not in (self.coordinator_name, task.source)}
        coord_view = self._view(coordinator, exact=True)
        target = self.policy.decide_coordinator(task, now, coord_view, peers)
        if target != self.coordinator_name:
            link = links.get(target)
            if link is None or not link.send(task.size_kb):
                return self._lost()
        return self._place(task, target, workers, on_done)

    def _place(self, task, name, workers: Dict[str, Worker],
               on_done) -> bool:
        w = workers.get(name)
        if w is None or w.stopped:
            return self._lost()          # target vanished between view & place
        ok = w.submit(task, on_done)
        if not ok:
            return self._lost()          # stopped (scale-in race) / queue full
        with self._lock:
            self.stats.placements[name] = \
                self.stats.placements.get(name, 0) + 1
        return ok

    # ------------------------------------------------------------- results
    def drain_completions(self) -> List[Completion]:
        out: List[Completion] = []
        for w in self.workers.values():
            out.extend(w.drain_completions())
        return out

"""Update-Profile / Maintain-Profile — the paper's telemetry loop.

Every node runs an Update-Profile (UP) publisher; the coordinator's
Maintain-Profile (MP) table holds the last-received state per node.  The
coordinator never blocks on fresh state: decisions read whatever is in the
table (the paper's staleness-tolerant design, 20 ms period).

The same loop doubles as the training fleet's heartbeat/straggler feed
(``repro.ft``): a worker that stops publishing or whose step-time EWMA
drifts is flagged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.latency import NodeState
from repro_torch.core.profile import DeviceProfile


@dataclass
class HeartbeatRecord:
    state: NodeState
    profile: DeviceProfile
    received_at: float


class MaintainProfileTable:
    """Coordinator-side global profile table (MP)."""

    def __init__(self, staleness_alarm_ms: float = 1000.0):
        self._table: Dict[str, HeartbeatRecord] = {}
        self._lock = threading.Lock()
        self.staleness_alarm_ms = staleness_alarm_ms

    def update(self, name: str, state: NodeState,
               profile: DeviceProfile) -> None:
        with self._lock:
            self._table[name] = HeartbeatRecord(state, profile,
                                                time.monotonic() * 1e3)

    def snapshot(self) -> Dict[str, HeartbeatRecord]:
        with self._lock:
            return dict(self._table)

    def get(self, name: str) -> Optional[HeartbeatRecord]:
        with self._lock:
            return self._table.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._table.pop(name, None)

    def stale_nodes(self, now_ms: Optional[float] = None) -> List[str]:
        """Nodes whose last heartbeat exceeds the alarm threshold —
        candidates for failure handling / straggler mitigation."""
        now_ms = now_ms if now_ms is not None else time.monotonic() * 1e3
        with self._lock:
            return [n for n, r in self._table.items()
                    if now_ms - r.received_at > self.staleness_alarm_ms]

    def degraded_nodes(self) -> List[str]:
        """Nodes whose last heartbeat advertised brownout degradation —
        still alive and routable, but serving clamped responses under
        overload (the honest-telemetry counterpart of ``stale_nodes``)."""
        with self._lock:
            return sorted(n for n, r in self._table.items()
                          if getattr(r.state, "brownout", False))


class UpdateProfilePublisher:
    """Node-side periodic state publisher (UP).  ``state_fn`` samples the
    node's live counters; publishing runs on a daemon thread.

    Each heartbeat publishes a *snapshot* (``profile.copy()``), never the
    live object: the node's UP loop keeps EWMA-mutating its own profile
    (``observe_runtime`` / ``observe_step``) while router threads read the
    MP table concurrently, so sharing by reference would let a predictor
    read a half-updated curve.  Readers get a stable profile at most one
    heartbeat stale — exactly the paper's staleness-tolerant contract."""

    def __init__(self, name: str, profile: DeviceProfile,
                 state_fn: Callable[[], NodeState],
                 table: MaintainProfileTable, period_ms: float = 20.0):
        self.name = name
        self.profile = profile
        self.state_fn = state_fn
        self.table = table
        self.period_ms = period_ms
        # while True, publish_once is a no-op: the node looks silent to the
        # MP table and trips its staleness alarm one alarm window later.
        # This is the network-partition (and crashed-process) surface the
        # fault injector (repro.ft.faults) flips — detection then runs the
        # exact code path a real partition would exercise.
        self.suppressed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> None:
        if self.suppressed:
            return
        self.table.update(self.name, self.state_fn(), self.profile.copy())

    def start(self) -> None:
        self.publish_once()

        def loop():
            while not self._stop.wait(self.period_ms / 1e3):
                self.publish_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"up-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

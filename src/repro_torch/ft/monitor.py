"""Fault tolerance: heartbeats, straggler detection, failure handling.

This is the paper's UP/MP telemetry loop applied to a training fleet:
workers publish step latencies; the monitor keeps per-worker EWMA/variance
and flags (a) **stragglers** — step time drifting beyond a z-score threshold
of the fleet median — and (b) **dead workers** — heartbeat silence past the
alarm window.  The driver responds by re-balancing (DDS re-placement) or by
triggering an elastic rescale from the last checkpoint.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.telemetry import MaintainProfileTable

log = logging.getLogger(__name__)


@dataclass
class WorkerStepStats:
    ewma_ms: float = 0.0
    var_ms: float = 0.0
    count: int = 0
    last_seen_ms: float = 0.0

    def observe(self, step_ms: float, alpha: float = 0.2) -> None:
        if self.count == 0:
            self.ewma_ms = step_ms
        delta = step_ms - self.ewma_ms
        self.ewma_ms += alpha * delta
        self.var_ms = (1 - alpha) * (self.var_ms + alpha * delta * delta)
        self.count += 1
        self.last_seen_ms = time.monotonic() * 1e3


@dataclass
class FleetHealth:
    stragglers: List[str]
    dead: List[str]
    median_ms: float


class StragglerMonitor:
    """Step-time EWMA z-score straggler detection over the fleet."""

    def __init__(self, z_threshold: float = 3.0, rel_threshold: float = 1.5,
                 dead_after_ms: float = 5_000.0, min_steps: int = 3):
        self.z = z_threshold
        self.rel = rel_threshold
        self.dead_after_ms = dead_after_ms
        self.min_steps = min_steps
        self.stats: Dict[str, WorkerStepStats] = {}
        self._incarnation: Dict[str, int] = {}
        self._lock = threading.Lock()

    def observe(self, worker: str, step_ms: float,
                incarnation: int = 0) -> None:
        """Fold one step sample into ``worker``'s EWMA.

        ``incarnation`` guards against name recycling (the simulator's
        kill/rejoin semantics): a worker that dies and rejoins under the
        same name is a *new* process whose step distribution owes nothing
        to the dead one's, so a sample from a newer incarnation resets the
        stats instead of inheriting the corpse's EWMA — and a straggling
        ghost sample from an older incarnation (in flight across the
        rejoin) is dropped rather than polluting the fresh record."""
        with self._lock:
            cur = self._incarnation.get(worker, 0)
            if incarnation < cur:
                return                          # stale incarnation's sample
            if incarnation > cur or worker not in self.stats:
                self._incarnation[worker] = incarnation
                self.stats[worker] = WorkerStepStats()
            self.stats[worker].observe(step_ms)

    def forget(self, worker: str) -> None:
        """Drop ``worker``'s record entirely (left the fleet for good)."""
        with self._lock:
            self.stats.pop(worker, None)
            self._incarnation.pop(worker, None)

    def health(self, now_ms: Optional[float] = None) -> FleetHealth:
        now_ms = now_ms if now_ms is not None else time.monotonic() * 1e3
        with self._lock:
            items = {k: v for k, v in self.stats.items()
                     if v.count >= self.min_steps}
            if not items:
                return FleetHealth([], [], 0.0)
            ewmas = sorted(v.ewma_ms for v in items.values())
            median = ewmas[len(ewmas) // 2]
            stragglers, dead = [], []
            for name, st in items.items():
                if now_ms - st.last_seen_ms > self.dead_after_ms:
                    dead.append(name)
                    continue
                sd = math.sqrt(max(st.var_ms, 1e-9))
                zscore = (st.ewma_ms - median) / max(sd, 1e-6)
                if st.ewma_ms > self.rel * median and zscore > self.z:
                    stragglers.append(name)
            return FleetHealth(sorted(stragglers), sorted(dead), median)


class FleetMonitor:
    """Serving-side liveness monitor: the detection half of failover.

    Polls two independent signals every ``poll_ms``:

      * **staleness** — ``table.stale_nodes()`` over the MP table, whose
        alarm the owning fleet derives from its heartbeat period (a
        crashed process and a partitioned node both stop publishing);
      * **progress** — an optional ``stalled_fn`` returning replicas that
        hold admitted work but have stopped advancing (a *hung* decode
        executable's heartbeat thread keeps publishing, so staleness
        alone would never catch it).

    Each replica is declared dead **once** (``on_dead(name, reason)``,
    invoked outside any monitor lock); a subsequent ``revive(name)`` —
    e.g. the replica rejoining after a partition heals — re-arms
    detection for that name.  ``check_once`` is exposed for deterministic
    tests; ``start`` runs it on a daemon thread."""

    def __init__(self, table: MaintainProfileTable,
                 on_dead: Callable[[str, str], None],
                 poll_ms: float = 20.0,
                 stalled_fn: Optional[Callable[[], List[str]]] = None):
        self.table = table
        self.on_dead = on_dead
        self.poll_ms = poll_ms
        self.stalled_fn = stalled_fn
        self.skew_factor = 5.0          # sweep-gap starvation guard (below)
        self._last_sweep_ms: Optional[float] = None
        self._declared: Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self, now_ms: Optional[float] = None) -> List[str]:
        """One detection sweep; returns the names newly declared dead.

        Starvation guard: when this sweep itself arrives far later than
        scheduled (``skew_factor`` × ``poll_ms``), the *process* was
        stalled — a GC pause, an XLA compile, CPU starvation — and every
        liveness clock in it (heartbeat receipt times, progress clocks) is
        suspect: the publishers were starved by the same pause that
        delayed us.  Declaring deaths off a lying clock evicts healthy
        replicas, so the sweep abstains and waits for one clean interval
        (a genuinely dead node is still dead next sweep)."""
        now = now_ms if now_ms is not None else time.monotonic() * 1e3
        last = self._last_sweep_ms
        self._last_sweep_ms = now
        if last is not None and now - last > self.skew_factor * self.poll_ms:
            log.debug("FleetMonitor: sweep arrived %.0fms late; abstaining",
                      now - last - self.poll_ms)
            return []
        suspects: Dict[str, str] = {}
        for n in self.table.stale_nodes(now_ms):
            suspects.setdefault(n, "heartbeat silence past staleness alarm")
        if self.stalled_fn is not None:
            for n in self.stalled_fn():
                suspects.setdefault(n, "decode progress stalled")
        newly: List[str] = []
        with self._lock:
            for n in suspects:
                if n not in self._declared:
                    self._declared.add(n)
                    newly.append(n)
        for n in newly:                 # callback outside the lock: it may
            self.on_dead(n, suspects[n])    # call back into revive()
        return newly

    def revive(self, name: str) -> None:
        """Re-arm detection for ``name`` (rejoin after eviction)."""
        with self._lock:
            self._declared.discard(name)

    def degraded_nodes(self) -> List[str]:
        """Replicas advertising brownout in their latest heartbeat — a
        health dimension between fine and dead: alive, routable, but
        degrading service under overload.  Surfaced here so operators
        watching the monitor see overload where they already look for
        stragglers and deaths."""
        return self.table.degraded_nodes()

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.poll_ms / 1e3):
                try:
                    self.check_once()
                except Exception:       # detection must outlive a bad sweep
                    log.exception("FleetMonitor sweep failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


@dataclass
class FailureEvent:
    worker: str
    at_step: int
    kind: str          # "dead" | "straggler"


class RecoveryPlan:
    """Maps a health report to actions the driver executes:
       - dead worker     -> drop from mesh, elastic rescale from checkpoint
       - straggler       -> deprioritize in DDS placement (weight its
                            profile's contention curve up), keep in mesh."""

    def __init__(self, monitor: StragglerMonitor,
                 table: Optional[MaintainProfileTable] = None):
        self.monitor = monitor
        self.table = table
        self.events: List[FailureEvent] = []

    def actions(self, step: int) -> Dict[str, List[str]]:
        h = self.monitor.health()
        if self.table is not None:
            for name in self.table.stale_nodes():
                if name not in h.dead:
                    h.dead.append(name)
        for w in h.dead:
            self.events.append(FailureEvent(w, step, "dead"))
        for w in h.stragglers:
            self.events.append(FailureEvent(w, step, "straggler"))
        return {"rescale_without": h.dead, "deprioritize": h.stragglers}

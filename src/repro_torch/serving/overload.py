"""Overload control for the serving fleet: priority classes, brownout
degradation, and per-replica circuit breakers.

The paper's admission insight — "any application requests with a time
constraint less than this [feasibility floor] should be rejected" — is
only the first line of defense.  Past saturation a fleet needs policies
for the requests it *did* admit: which queued work to shed when the
queue can no longer drain in time, how a replica degrades service
instead of missing every deadline at once, and how retry traffic stops
re-slamming a replica that keeps failing.  This module holds the three
mechanism pieces; the policy wiring lives in ``repro.serving.engine``
(``Replica`` runs the brownout controller and the shed sweep,
``ServingFleet`` runs admission and the breakers) and the failure
taxonomy they produce is documented in ``docs/FAULTS.md``.

Everything here is deliberately model-free: plain counters and
thresholds driven by the engine's measured signals (step-time EWMA,
queue depth, failure streaks), so the same classes are unit-testable
with synthetic samples and a fake clock.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)


# ------------------------------------------------------------- priorities
#: Priority classes, best first.  Lower rank = more important: queues
#: order (rank, absolute deadline), so interactive requests sit ahead of
#: batch requests and EDF breaks ties within a class; overload shedding
#: walks the same order backwards (lowest priority, latest deadline
#: first).
PRIORITIES = ("interactive", "batch")
_RANK = {name: i for i, name in enumerate(PRIORITIES)}


def priority_rank(priority: str) -> int:
    """Numeric rank of a priority class (0 = most important).  Unknown
    classes rank below every known one rather than raising — a malformed
    client must not crash admission, only deprioritize itself."""
    return _RANK.get(priority, len(PRIORITIES))


# --------------------------------------------------------------- brownout
@dataclass
class BrownoutConfig:
    """Knobs for reversible degradation under sustained pressure.

    Pressure is sampled once per decode-loop iteration from two live
    signals: the step-time EWMA against ``step_slo_ms`` and the waiting
    queue depth.  Both edges carry hysteresis — a *band* (engage above
    ``step_slo_ms``/``queue_high``, restore only below
    ``restore_ratio * step_slo_ms``/``queue_low``) and a *dwell*
    (``engage_after``/``restore_after`` consecutive samples) — so a
    replica hovering at the threshold never flaps.
    """

    step_slo_ms: float = 0.0        # pressure reference; <= 0: queue-only
    queue_high: int = 8             # queue depth that counts as pressure
    queue_low: int = 1              # queue depth that counts as clear
    engage_after: int = 4           # consecutive over-pressure samples
    restore_after: int = 8          # consecutive clear samples
    restore_ratio: float = 0.7      # clear band: ewma <= ratio * slo
    budget_factor: float = 0.25     # prefill-ceiling shrink while engaged
    max_new_tokens_cap: int = 0     # clamp admitted decode budgets (0: off)
    alpha: float = 0.3              # step-time EWMA weight


class BrownoutController:
    """Hysteresis state machine deciding when a replica is browned out.

    ``observe(step_ms, queue_depth)`` is called by the owning replica's
    decode loop (single writer); ``engaged`` may be read from any thread
    (heartbeat/state readers) — it is a plain bool, updated atomically
    under the GIL.  ``transitions`` counts engage+restore flips, the
    signal the no-flapping test pins down.
    """

    def __init__(self, cfg: BrownoutConfig):
        self.cfg = cfg
        self.engaged = False
        self.transitions = 0
        self.ewma_ms = 0.0
        self._over = 0          # consecutive over-pressure samples
        self._clear = 0         # consecutive clear samples

    def observe(self, step_ms: float, queue_depth: int) -> bool:
        """Feed one pressure sample; returns the (possibly new) engaged
        state.  Samples in the hysteresis band — neither over-pressure
        nor clear — reset both dwell counters, so only *sustained*
        pressure engages and only *sustained* calm restores."""
        c = self.cfg
        if self.ewma_ms <= 0.0:
            self.ewma_ms = step_ms
        else:
            self.ewma_ms += c.alpha * (step_ms - self.ewma_ms)
        slo = c.step_slo_ms
        over = (slo > 0.0 and self.ewma_ms > slo) or queue_depth >= c.queue_high
        clear = ((slo <= 0.0 or self.ewma_ms <= c.restore_ratio * slo)
                 and queue_depth <= c.queue_low)
        if over:
            self._over += 1
            self._clear = 0
        elif clear:
            self._clear += 1
            self._over = 0
        else:                       # in the band: sustain nothing
            self._over = 0
            self._clear = 0
        if not self.engaged and self._over >= c.engage_after:
            self.engaged = True
            self.transitions += 1
            self._over = 0
            log.info("brownout ENGAGED (step ewma %.2fms, queue %d)",
                     self.ewma_ms, queue_depth)
        elif self.engaged and self._clear >= c.restore_after:
            self.engaged = False
            self.transitions += 1
            self._clear = 0
            log.info("brownout restored (step ewma %.2fms, queue %d)",
                     self.ewma_ms, queue_depth)
        return self.engaged


# --------------------------------------------------------- circuit breaker
class CircuitBreaker:
    """Per-replica breaker: open -> half-open probe -> close.

    ``failure_threshold`` consecutive retryable failures open the
    breaker; while open, ``available()`` is False and the router stops
    sending traffic (retries re-slamming a sick replica are exactly the
    load that keeps it sick).  After ``open_ms`` the breaker admits ONE
    probe request (half-open): its success closes the breaker, its
    failure re-opens the cooldown.  All transitions are lock-guarded —
    router threads race on ``acquire`` — and every timestamp can be
    injected (``now_ms``) so tests drive the state machine with a fake
    clock.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3, open_ms: float = 500.0):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.open_ms = open_ms
        self.state = self.CLOSED
        self.failures = 0           # consecutive failures while closed
        self.opened_at_ms = 0.0
        self.opens = 0              # times the breaker tripped (telemetry)
        self._probing = False       # a half-open probe is in flight
        self._lock = threading.Lock()

    def _now(self, now_ms: Optional[float]) -> float:
        return now_ms if now_ms is not None else time.monotonic() * 1e3

    def available(self, now_ms: Optional[float] = None) -> bool:
        """Non-consuming routing check: would a request be allowed now?
        True while closed, True when an open breaker's cooldown has
        elapsed (a probe is due), True in half-open only while no probe
        is already in flight."""
        now = self._now(now_ms)
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return now - self.opened_at_ms >= self.open_ms
            return not self._probing

    def acquire(self, now_ms: Optional[float] = None) -> bool:
        """Consume permission to dispatch one request.  An open breaker
        whose cooldown elapsed transitions to half-open here and grants
        the single probe slot; a second caller racing for it loses."""
        now = self._now(now_ms)
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if now - self.opened_at_ms < self.open_ms:
                    return False
                self.state = self.HALF_OPEN
                self._probing = False
            if self._probing:
                return False
            self._probing = True
            return True

    def on_success(self) -> None:
        """A dispatched request completed: close (the probe healed the
        breaker) and reset the failure streak."""
        with self._lock:
            self.state = self.CLOSED
            self.failures = 0
            self._probing = False

    def on_failure(self, now_ms: Optional[float] = None) -> None:
        """A dispatched request failed retryably.  A half-open probe
        failure re-opens immediately; while closed, ``failure_threshold``
        consecutive failures trip the breaker."""
        now = self._now(now_ms)
        with self._lock:
            if self.state == self.HALF_OPEN:
                self.state = self.OPEN
                self.opened_at_ms = now
                self.opens += 1
                self._probing = False
                return
            self.failures += 1
            if self.state == self.CLOSED and \
                    self.failures >= self.failure_threshold:
                self.state = self.OPEN
                self.opened_at_ms = now
                self.opens += 1

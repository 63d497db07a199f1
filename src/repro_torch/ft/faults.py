"""Fault injection for the serving fleet — reproducible chaos.

The paper's premise is a *dynamically varying* environment; this module
makes the variation injectable so every failure mode the fleet claims to
survive is exercised by tests and benchmarks, not asserted on faith.

A ``FaultPlan`` is a timed script of events against one replica:

  * ``crash``      — the decode thread dies mid-step (``SystemExit``
                     raised inside the wrapped step; threads swallow it
                     silently, exactly like a killed process) and the
                     UP heartbeat goes silent (a dead process publishes
                     nothing).  Detected by the staleness alarm; in-flight
                     requests fail over.
  * ``hang``       — the decode loop stalls before its next step, but the
                     heartbeat thread keeps publishing (a wedged
                     executable, not a dead node).  Staleness never fires;
                     only the progress watchdog catches this.
  * ``slow(f)``    — every decode step / prefill chunk takes ``f``× its
                     real wall-clock.  Not a failure: the Update-Profile
                     EWMA absorbs the new step time and routing shifts
                     load away — the paper's adaptation loop, observable.
  * ``partition``  — heartbeats are suppressed (``publisher.suppressed``)
                     while the decode loop keeps running: the node is
                     healthy but unreachable.  The fleet must evict it
                     (staleness) and re-route; a later ``heal`` lets it
                     publish again (rejoin via ``add_replica``).
  * ``heal``       — undo hang/slow/partition (a crash is permanent: dead
                     processes do not self-resurrect).

``FaultInjector`` wraps a live ``Replica`` by interposing on its
``_decode_step`` / ``_advance_prefill`` (the two places the decode thread
does work), so faults land at the exact points a real fault would: between
or inside steps, never between Python statements chosen by luck.  Faults
can be applied directly (``apply``) for deterministic tests, or on the
plan's clock (``arm``) for benchmarks.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

log = logging.getLogger(__name__)

KINDS = ("crash", "hang", "slow", "partition", "heal")


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault: ``at_ms`` is relative to ``FaultInjector.arm()``.
    ``factor`` only applies to ``slow`` (step-time multiplier, > 1)."""

    at_ms: float
    kind: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow factor must be > 1, got {self.factor}")


def crash(at_ms: float) -> FaultEvent:
    return FaultEvent(at_ms, "crash")


def hang(at_ms: float) -> FaultEvent:
    return FaultEvent(at_ms, "hang")


def slow(at_ms: float, factor: float) -> FaultEvent:
    return FaultEvent(at_ms, "slow", factor)


def partition(at_ms: float) -> FaultEvent:
    return FaultEvent(at_ms, "partition")


def heal(at_ms: float) -> FaultEvent:
    return FaultEvent(at_ms, "heal")


@dataclass
class FaultPlan:
    """A time-ordered script of fault events against one replica."""

    events: List[FaultEvent]

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.at_ms)


class FaultInjector:
    """Interpose a ``FaultPlan`` on a live ``Replica``.

    ``publisher`` is the replica's ``UpdateProfilePublisher`` (pass it for
    crash/partition to silence heartbeats the way a real death would —
    without it those faults only stop the decode loop and detection falls
    to the progress watchdog alone).  Restore the replica's original
    methods with ``stop()``; an injector is single-use.
    """

    def __init__(self, replica, plan: Optional[FaultPlan] = None,
                 publisher=None):
        self.replica = replica
        self.plan = plan or FaultPlan([])
        self.publisher = publisher
        self.mode = "ok"                # ok | crash | hang | slow
        self.slow_factor = 1.0
        self.fired: List[FaultEvent] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._timer: Optional[threading.Thread] = None
        # interpose crash/hang on the decode thread's two work sites...
        self._orig_decode = replica._decode_step
        self._orig_prefill = replica._advance_prefill
        replica._decode_step = self._wrap(self._orig_decode)
        replica._advance_prefill = self._wrap(self._orig_prefill)
        # ...and slow(f) on the executables themselves, INSIDE the window
        # the decode loop times: the inflated wall-clock must reach
        # observe_step / observe_prefill_chunk (the UP loop), or routing
        # could never adapt to a degraded node.  ``_step`` and
        # ``_step_sampled`` serve ring and paged lanes alike, so a paged
        # decode step is stretched too
        self._orig_exec = {}
        for attr in ("_step", "_step_sampled", "_prefill_chunk"):
            self._orig_exec[attr] = getattr(replica, attr)
            setattr(replica, attr, self._slowable(self._orig_exec[attr]))

    # ------------------------------------------------------------- the gate
    def _wrap(self, fn):
        def gated(*args, **kwargs):
            self._gate()
            return fn(*args, **kwargs)
        return gated

    def _slowable(self, fn):
        def slowed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            with self._lock:
                factor = self.slow_factor if self.mode == "slow" else 1.0
            if factor > 1.0:
                # wait for the device (every device of a sharded replica's
                # mesh; a no-op on the CPU) so the padding is proportional
                # to the real compute, then stretch to factor;
                # ``out`` may hold host arrays beside device tensors
                # (``_step_sampled``: tokens, keys), so it is not touched
                self.replica._sync()
                time.sleep((time.perf_counter() - t0) * (factor - 1.0))
            return out
        return slowed

    def _gate(self) -> None:
        with self._lock:
            mode = self.mode
        if mode == "crash":
            # SystemExit in a non-main thread is swallowed silently —
            # the decode thread just stops existing, like a killed process
            raise SystemExit(f"fault injection: {self.replica.name} crashed")
        while mode == "hang" and not self.replica._shutdown:
            time.sleep(0.001)
            with self._lock:
                mode = self.mode
        if mode == "crash":             # crashed while hung
            raise SystemExit(f"fault injection: {self.replica.name} crashed")

    # ------------------------------------------------------------- controls
    def apply(self, kind: str, factor: float = 1.0) -> None:
        """Apply one fault now (deterministic-test entry point)."""
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._lock:
            if kind == "crash":
                self.mode = "crash"
                if self.publisher is not None:
                    self.publisher.suppressed = True    # dead processes
            elif kind == "hang":                        # don't heartbeat
                self.mode = "hang"
            elif kind == "slow":
                self.mode = "slow"
                self.slow_factor = factor
            elif kind == "partition":
                if self.publisher is not None:
                    self.publisher.suppressed = True
            elif kind == "heal":
                if self.mode != "crash":                # no resurrection
                    self.mode = "ok"
                    self.slow_factor = 1.0
                    if self.publisher is not None:
                        self.publisher.suppressed = False
        log.info("fault injected on %s: %s%s", self.replica.name, kind,
                 f"(x{factor})" if kind == "slow" else "")

    def arm(self) -> None:
        """Replay the plan on wall-clock time from now (benchmark mode)."""
        t0 = time.monotonic() * 1e3

        def loop():
            for ev in self.plan.events:
                while not self._stop.is_set():
                    delay_ms = ev.at_ms - (time.monotonic() * 1e3 - t0)
                    if delay_ms <= 0:
                        break
                    self._stop.wait(min(delay_ms, 5.0) / 1e3)
                if self._stop.is_set():
                    return
                self.apply(ev.kind, ev.factor)
                self.fired.append(ev)

        self._timer = threading.Thread(target=loop, daemon=True,
                                       name=f"faults-{self.replica.name}")
        self._timer.start()

    def stop(self) -> None:
        """Cancel pending events and un-interpose (the replica keeps any
        already-applied fault state: a crashed replica stays crashed)."""
        self._stop.set()
        if self._timer:
            self._timer.join(timeout=1.0)
        self.replica._decode_step = self._orig_decode
        self.replica._advance_prefill = self._orig_prefill
        for attr, fn in self._orig_exec.items():
            setattr(self.replica, attr, fn)


def inject(fleet, name: str, plan: Optional[FaultPlan] = None) -> FaultInjector:
    """Convenience: build an injector for fleet replica ``name`` with its
    heartbeat publisher attached (so crash/partition silence the UP loop
    exactly as a real process death / network split would)."""
    rep = fleet.replicas[name]
    pub = fleet._publishers.get(name)
    return FaultInjector(rep, plan, publisher=pub)

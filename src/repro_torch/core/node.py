"""Live fleet: worker nodes executing real callables under slot limits.

``Worker`` is the runtime counterpart of the simulator's ``_SimNode``: a
device with ``slots`` warm execution lanes (threads), a bounded waiting
queue (the paper's q_image), live counters feeding the UP publisher, and a
certification handshake for joining a fleet (the paper's device
certification before admission).

This is what the serving engine schedules onto; on this host the "devices"
are processes/threads around the model's callables, on a real fleet they are
pod slices behind RPC.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.latency import NodeState, Task
from repro_torch.core.profile import AppProfile, DeviceProfile


@dataclass
class Completion:
    task: Task
    started_ms: float
    finished_ms: float
    node: str
    result: Any = None
    error: Optional[str] = None

    @property
    def latency_ms(self) -> float:
        return self.finished_ms - self.task.created_ms

    @property
    def met(self) -> bool:
        return self.error is None and self.latency_ms <= self.task.constraint_ms


class Worker:
    """A device with ``slots`` warm lanes executing submitted tasks."""

    def __init__(self, profile: DeviceProfile,
                 app_fns: Dict[str, Callable[[Task], Any]],
                 queue_capacity: int = 1024,
                 discipline: str = "fifo"):
        self.profile = profile
        self.name = profile.device_id
        self.app_fns = app_fns
        self.discipline = discipline
        self._q: "queue.Queue" = (queue.PriorityQueue()
                                  if discipline == "edf" else queue.Queue())
        self._capacity = queue_capacity
        self._running = 0
        self._queued = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._completions: "queue.Queue[Completion]" = queue.Queue()
        self._seq = 0

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        for i in range(self.profile.slots):
            t = threading.Thread(target=self._lane, daemon=True,
                                 name=f"{self.name}-lane{i}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self._lock:                 # serialize against submit: after
            self._stop.set()             # this, submit refuses new tasks
        for _ in self._threads:
            self._q.put((float("inf"), -1, None, None))
        for t in self._threads:
            t.join(timeout=2.0)
        self._drain_stranded()

    def _drain_stranded(self) -> None:
        """Tasks that slipped into the queue around shutdown (or were queued
        behind long work) are completed with an error so callers waiting on
        ``on_done`` never hang — the fleet's 'lost, not crashed' contract."""
        while True:
            try:
                _, _, task, on_done = self._q.get_nowait()
            except queue.Empty:
                return
            if task is None:
                continue
            with self._lock:
                self._queued -= 1
            now = time.monotonic() * 1e3
            comp = Completion(task, now, now, self.name, None,
                              error="worker stopped")
            self._completions.put(comp)
            if on_done is not None:
                on_done(comp)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    # ----------------------------------------------------------- submission
    def submit(self, task: Task, on_done: Optional[Callable] = None) -> bool:
        with self._lock:
            # stop-check and enqueue share the lock with stop()'s flag-set,
            # so a scale-in racing a submit either refuses the task here
            # (fleet accounts it lost) or enqueues it where stop()'s
            # stranded-task drain will error-complete it — a caller
            # blocking on on_done can never hang.
            if self._stop.is_set():
                return False
            if self._queued >= self._capacity:
                return False
            self._queued += 1
            self._seq += 1
            prio = (task.created_ms + task.constraint_ms
                    if self.discipline == "edf" else self._seq)
            self._q.put((prio, self._seq, task, on_done))
        return True

    # -------------------------------------------------------------- workers
    def _lane(self) -> None:
        while not self._stop.is_set():
            prio, _, task, on_done = self._q.get()
            if task is None:
                return
            with self._lock:
                self._queued -= 1
                self._running += 1
                conc = self._running
            t0 = time.monotonic() * 1e3
            result, error = None, None
            try:
                result = self.app_fns[task.app_id](task)
            except Exception as e:           # noqa: BLE001 — report, don't die
                error = f"{type(e).__name__}: {e}"
            t1 = time.monotonic() * 1e3
            with self._lock:
                self._running -= 1
            # Update-Profile: feed the observation back into the live profile
            app = self.profile.apps.get(task.app_id)
            if app is not None and error is None:
                app.observe_runtime(t1 - t0, conc, task.size_kb,
                                    self.profile.cpu_load)
            comp = Completion(task, t0, t1, self.name, result, error)
            self._completions.put(comp)
            if on_done is not None:
                on_done(comp)

    # ------------------------------------------------------------ telemetry
    def state(self) -> NodeState:
        with self._lock:
            return NodeState(running=self._running, queued=self._queued,
                             cpu_load=self.profile.cpu_load,
                             updated_ms=time.monotonic() * 1e3)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return max(self.profile.slots - self._running - self._queued, 0)

    def drain_completions(self) -> List[Completion]:
        out = []
        while True:
            try:
                out.append(self._completions.get_nowait())
            except queue.Empty:
                return out


def certify(profile: DeviceProfile, required_apps: List[str],
            min_slots: int = 1) -> Tuple[bool, str]:
    """The paper's device-certification step before a node may join."""
    missing = [a for a in required_apps if a not in profile.apps]
    if missing:
        return False, f"missing app profiles: {missing}"
    if profile.slots < min_slots:
        return False, f"needs >= {min_slots} warm slots, has {profile.slots}"
    return True, "ok"

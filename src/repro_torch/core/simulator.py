"""Discrete-event simulator of the paper's two-level edge architecture.

Faithfully models the evaluation setup of Section V:

  camera -> Rasp1 (source; local decision) --WiFi--> edge server (coordinator;
  global decision over stale heartbeat views) --WiFi--> Rasp2 (peer)

  * warm-container slots per node (Table V/VI contention applies at start),
  * FIFO (or EDF) per-node waiting queues (the paper's q_image),
  * Update-Profile heartbeats: the coordinator sees peer state that is up to
    ``heartbeat_ms`` stale (paper: 20 ms) — decisions tolerate staleness,
  * UDP-style message loss on links (paper sends requests over UDP),
  * background CPU load on the coordinator (Fig 7/8 stress parameter),
  * **churn**: timed ``ChurnEvent``s kill / rejoin / partition / heal a
    node mid-run.  Death is detected ``detect_ms`` after the fact (the
    staleness-alarm window); until then the coordinator keeps routing to
    the dead node on its stale view — those tasks, plus the ones the node
    held when it died, re-enter at the source after the detection delay
    (bounded, deadline-aware retries), exactly mirroring the serving
    fleet's failover path.  Stale-incarnation finish events are discarded
    (a kill+rejoin must not resurrect the old run's completions) and a
    task that completes on two placements (retry raced the original)
    counts once — first completion wins.

Deterministic given the config (loss draws use a seeded RNG).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.admission import admit
from repro_torch.core.latency import NodeState, Task
from repro_torch.core.policies import FORWARD, LOCAL, NodeView, Policy
from repro_torch.core.profile import (FACE, DeviceProfile,
                                      paper_edge_server, paper_raspberry_pi)

CHURN_KINDS = ("kill", "rejoin", "partition", "heal")


@dataclass(frozen=True)
class ChurnEvent:
    """One timed membership change: at ``at_ms``, ``node`` is killed
    (process death: queue and running work vanish), rejoins empty,
    is partitioned (keeps computing, but nothing in or out), or heals."""

    at_ms: float
    kind: str
    node: str

    def __post_init__(self):
        if self.kind not in CHURN_KINDS:
            raise ValueError(f"unknown churn kind {self.kind!r}; "
                             f"expected one of {CHURN_KINDS}")


@dataclass
class SimConfig:
    num_tasks: int = 50
    interval_ms: float = 50.0
    constraint_ms: float = 1000.0
    image_kb: float = 29.0
    result_kb: float = 1.0
    heartbeat_ms: float = 20.0
    edge_cpu_load: float = 0.0
    include_rasp2: bool = True
    edge_slots: int = 8
    rpi_slots: int = 4
    seed: int = 0
    loss_prob: float = 0.0
    churn: Tuple[ChurnEvent, ...] = ()
    detect_ms: float = 100.0        # staleness-alarm window (death -> known)
    retry_max: int = 3              # placements per task, first included
    # overload control (mirrors ServingFleet/Replica): a feasibility-floor
    # admission gate at the source (> 0 enables; margin scales the floor)
    # and a bounded per-node waiting queue (> 0 enables; a full queue
    # sheds in queue order — the worst-keyed task, arrival included)
    admission_margin: float = 0.0
    max_queue: int = 0


@dataclass
class TaskRecord:
    task: Task
    finished_ms: float = float("inf")
    node: str = ""
    dropped: bool = False
    attempts: int = 1               # placements tried (>1: failed over)
    lost: bool = False              # terminally failed: retries exhausted
                                    # or no deadline slack left to retry in
    rejected: bool = False          # admission: deadline below the floor
    shed: bool = False              # overload: evicted from a full queue
    infeasible: bool = False        # lost with zero slack remaining — no
                                    # scheduler could have met it (churn ate
                                    # the deadline); kept distinct so hit
                                    # rates read scheduling quality, not
                                    # physics

    @property
    def latency_ms(self) -> float:
        return self.finished_ms - self.task.created_ms

    @property
    def met(self) -> bool:
        return self.latency_ms <= self.task.constraint_ms


@dataclass
class SimResult:
    policy: str
    config: SimConfig
    records: List[TaskRecord]

    @property
    def num_met(self) -> int:
        return sum(1 for r in self.records if r.met)

    @property
    def num_lost(self) -> int:
        return sum(1 for r in self.records if r.lost)

    @property
    def num_failed_over(self) -> int:
        return sum(1 for r in self.records if r.attempts > 1)

    @property
    def num_rejected(self) -> int:
        return sum(1 for r in self.records if r.rejected)

    @property
    def num_shed(self) -> int:
        return sum(1 for r in self.records if r.shed)

    @property
    def num_dropped(self) -> int:
        return sum(1 for r in self.records if r.dropped)

    @property
    def num_infeasible(self) -> int:
        return sum(1 for r in self.records if r.infeasible)

    @property
    def num_admitted(self) -> int:
        return len(self.records) - self.num_rejected

    @property
    def hit_rate(self) -> float:
        """Deadline hits over tasks the scheduler was actually accountable
        for: admitted, and not rendered infeasible by churn (a task whose
        slack was consumed by a detection window no policy controls).
        ``num_met / num_tasks`` conflated those with scheduling misses and
        made churn hit-rates unreadable; the raw ratio stays available as
        ``num_met / len(records)``."""
        denom = self.num_admitted - self.num_infeasible
        return self.num_met / max(denom, 1)

    @property
    def latencies(self) -> List[float]:
        return [r.latency_ms for r in self.records if r.finished_ms < float("inf")]

    def placement_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.node] = out.get(r.node, 0) + 1
        return out


class _SimNode:
    def __init__(self, profile: DeviceProfile):
        self.profile = profile
        self.name = profile.device_id
        self.running = 0
        # priority heap of (key, seq, task, enqueue_time): key is arrival
        # time for FIFO, absolute deadline for EDF — O(log n) insert/pop
        # instead of re-sorting the whole queue on every insert
        self.waiting: List = []
        self.cpu_load = profile.cpu_load
        # churn state: a killed node's scheduled finish events carry the
        # old incarnation and are discarded when they fire
        self.alive = True
        self.partitioned = False
        self.incarnation = 0
        self.active: Dict[int, Task] = {}   # task_id -> running task

    @property
    def free_slots(self) -> int:
        return self.profile.slots - self.running

    def exact_state(self, now: float) -> NodeState:
        return NodeState(running=self.running, queued=len(self.waiting),
                         cpu_load=self.cpu_load, updated_ms=now)

    def view(self, state: NodeState) -> NodeView:
        free = max(self.profile.slots - state.running - state.queued, 0)
        return NodeView(profile=self.profile, state=state, free_slots=free)


class Simulator:
    """Event-driven executor for one (policy, config) run."""

    def __init__(self, policy: Policy, config: SimConfig,
                 fleet: Optional[Dict[str, DeviceProfile]] = None,
                 source: str = "rasp1", coordinator: str = "edge_server"):
        self.policy = policy
        self.cfg = config
        self.rng = random.Random(config.seed)
        if fleet is None:
            fleet = {"rasp1": paper_raspberry_pi("rasp1", config.rpi_slots),
                     "edge_server": paper_edge_server(config.edge_slots)}
            if config.include_rasp2:
                fleet["rasp2"] = paper_raspberry_pi("rasp2", config.rpi_slots)
        self.nodes = {n: _SimNode(p) for n, p in fleet.items()}
        self.nodes[coordinator].cpu_load = config.edge_cpu_load
        self.source = source
        self.coordinator = coordinator
        # coordinator's stale views of all peers (telemetry table)
        self._hb_views: Dict[str, NodeState] = {
            n: node.exact_state(0.0) for n, node in self.nodes.items()}
        self._events: List = []
        self._seq = itertools.count()
        self.records: Dict[int, TaskRecord] = {}
        self._n_done = 0
        # coordinator-side knowledge of deaths: a node enters this set only
        # detect_ms AFTER it actually died (the staleness-alarm window) —
        # until then routing keeps trusting the stale heartbeat view
        self._presumed_dead: set = set()

    # ----------------------------------------------------------- event loop
    def _push(self, when: float, fn: Callable, *args) -> None:
        heapq.heappush(self._events, (when, next(self._seq), fn, args))

    def run(self) -> SimResult:
        cfg = self.cfg
        for i in range(cfg.num_tasks):
            t_arrive = i * cfg.interval_ms
            task = Task(task_id=i, app_id=FACE, size_kb=cfg.image_kb,
                        created_ms=t_arrive, constraint_ms=cfg.constraint_ms,
                        result_kb=cfg.result_kb, source=self.source)
            self.records[i] = TaskRecord(task=task, node="")
            self._push(t_arrive, self._on_task_at_source, task)
        self._push(cfg.heartbeat_ms, self._on_heartbeat)
        for ev in cfg.churn:
            if ev.node == self.source:
                raise ValueError("churn on the source node is not modeled "
                                 "(tasks originate there)")
            if ev.node not in self.nodes:
                raise ValueError(f"churn on unknown node {ev.node!r}")
            self._push(ev.at_ms, self._on_churn, ev)

        horizon = cfg.num_tasks * cfg.interval_ms + 100 * cfg.constraint_ms + 1e7
        while self._events:
            when, _, fn, args = heapq.heappop(self._events)
            if when > horizon:
                break
            self._now = when
            fn(when, *args)
        return SimResult(self.policy.name, cfg, [self.records[i]
                                                 for i in sorted(self.records)])

    # ------------------------------------------------------------ telemetry
    def _on_heartbeat(self, now: float) -> None:
        for n, node in self.nodes.items():
            # dead/partitioned nodes publish nothing: their last view
            # freezes in the table (exactly the real UP/MP behavior) and
            # routing keeps trusting it until detection catches up
            if node.alive and not node.partitioned:
                self._hb_views[n] = node.exact_state(now)
        if self._n_done < self.cfg.num_tasks:
            self._push(now + self.cfg.heartbeat_ms, self._on_heartbeat)

    # ---------------------------------------------------------------- churn
    def _on_churn(self, now: float, ev: ChurnEvent) -> None:
        node = self.nodes[ev.node]
        if ev.kind == "kill":
            node.alive = False
            node.incarnation += 1       # in-flight finishes become stale
            victims = list(node.active.values()) + \
                [t for _, _, t, _ in node.waiting]
            node.active.clear()
            node.waiting.clear()
            node.running = 0
            self._push(now + self.cfg.detect_ms, self._detect_down, ev.node)
            # the node's work is only KNOWN lost after the detection window
            for t in victims:
                self._push(now + self.cfg.detect_ms, self._retry, t)
        elif ev.kind == "rejoin":
            node.alive = True
            node.partitioned = False
            node.running = 0
            node.active.clear()
            node.waiting.clear()
            self._presumed_dead.discard(ev.node)
            self._hb_views[ev.node] = node.exact_state(now)
        elif ev.kind == "partition":
            node.partitioned = True     # keeps computing; nothing in or out
            self._push(now + self.cfg.detect_ms, self._detect_down, ev.node)
        elif ev.kind == "heal":
            node.partitioned = False
            self._presumed_dead.discard(ev.node)
            self._hb_views[ev.node] = node.exact_state(now)

    def _detect_down(self, now: float, name: str) -> None:
        node = self.nodes[name]
        if not node.alive or node.partitioned:      # still down when the
            self._presumed_dead.add(name)           # alarm window elapses

    def _retry(self, now: float, task: Task) -> None:
        """Failover re-entry: the task's placement died (or its result was
        unreachable); re-run the source decision — deadline-aware and
        bounded, like ServingFleet.submit's retry loop."""
        rec = self.records[task.task_id]
        if rec.finished_ms < float("inf") or rec.lost:
            return                      # first completion already won
        slack = task.created_ms + task.constraint_ms - now
        if rec.attempts >= self.cfg.retry_max or slack <= 0:
            rec.lost = True             # visible terminal failure
            # zero slack means churn consumed the whole deadline budget —
            # no placement could have met this task; flag it so hit-rate
            # accounting separates physics from scheduling
            rec.infeasible = slack <= 0
            self._n_done += 1
            return
        rec.attempts += 1
        self._on_task_at_source(now, task)

    def _live_profiles(self) -> Dict[str, DeviceProfile]:
        """The source's view of routable capacity for admission: every node
        not known dead (a not-yet-detected death still counts — admission
        shares routing's staleness tolerance)."""
        return {n: node.profile for n, node in self.nodes.items()
                if n not in self._presumed_dead}

    # ------------------------------------------------------------- decisions
    def _on_task_at_source(self, now: float, task: Task) -> None:
        rec = self.records[task.task_id]
        if self.cfg.admission_margin > 0 and rec.attempts == 1:
            # feasibility-floor admission at first submission only (a
            # retry already sunk transfer/queue time; re-litigating its
            # deadline here would double-charge it)
            ok, _ = admit(self._live_profiles(), task, self.source,
                          self.cfg.admission_margin)
            if not ok:
                rec.rejected = True
                self._n_done += 1
                return
        src = self.nodes[self.source]
        decision = self.policy.decide_source(task, now, src.view(src.exact_state(now)))
        if decision == FORWARD and self.coordinator in self._presumed_dead:
            decision = LOCAL            # known-down coordinator: degrade
        if decision == LOCAL:
            self._enqueue(now, self.source, task)
        else:
            self._transfer(now, task, self.source, self.coordinator,
                           task.size_kb, self._on_task_at_coordinator)

    def _on_task_at_coordinator(self, now: float, task: Task) -> None:
        coord = self.nodes[self.coordinator]
        if not coord.alive or coord.partitioned:
            # arrived at a dead/unreachable coordinator: the source learns
            # one detection window later and re-routes
            self._push(now + self.cfg.detect_ms, self._retry, task)
            return
        peers = {n: self.nodes[n].view(self._hb_views[n])
                 for n in self.nodes
                 if n not in (self.coordinator, task.source)
                 and n not in self._presumed_dead}
        target = self.policy.decide_coordinator(
            task, now, coord.view(coord.exact_state(now)), peers)
        if target == self.coordinator:
            self._enqueue(now, target, task)
        else:
            self._transfer(now, task, self.coordinator, target,
                           task.size_kb, lambda t, tk: self._enqueue(t, target, tk))

    # -------------------------------------------------------------- network
    def _transfer(self, now: float, task: Task, src: str, dst: str,
                  size_kb: float, then: Callable) -> None:
        link = self.nodes[dst].profile.link
        if self.cfg.loss_prob and self.rng.random() < self.cfg.loss_prob:
            self.records[task.task_id].dropped = True      # UDP loss
            return
        self._push(now + link.transfer_time(size_kb), then, task)

    # ------------------------------------------------------------ execution
    def _enqueue(self, now: float, node_name: str, task: Task) -> None:
        node = self.nodes[node_name]
        if not node.alive or node.partitioned:
            # routed onto a node that died after the view was published:
            # the task vanishes for one detection window, then retries
            self._push(now + self.cfg.detect_ms, self._retry, task)
            return
        self.records[task.task_id].node = node_name
        if node.free_slots > 0:
            self._start(now, node_name, task)
            return
        if self.policy.queue_discipline == "edf":
            key = task.created_ms + task.constraint_ms   # abs deadline
        else:
            key = now                                    # FIFO arrival
        if self.cfg.max_queue > 0 and len(node.waiting) >= self.cfg.max_queue:
            # bounded queue: resolve in key order — shed the worst of
            # (queued tasks, arrival), mirroring the serving replica's
            # ReplicaSaturated eviction
            worst = max(node.waiting)
            if worst[0] <= key:
                self.records[task.task_id].shed = True
                self._n_done += 1
                return
            node.waiting.remove(worst)
            heapq.heapify(node.waiting)
            self.records[worst[2].task_id].shed = True
            self._n_done += 1
        heapq.heappush(node.waiting, (key, next(self._seq), task, now))

    def _start(self, now: float, node_name: str, task: Task) -> None:
        node = self.nodes[node_name]
        node.running += 1
        node.active[task.task_id] = task
        app = node.profile.app(task.app_id)
        proc = app.process_time(task.size_kb, node.running, node.cpu_load)
        self._push(now + proc, self._finish, node_name, task,
                   node.incarnation)

    def _finish(self, now: float, node_name: str, task: Task,
                inc: int = 0) -> None:
        node = self.nodes[node_name]
        if inc != node.incarnation:
            return      # finish from a killed incarnation: never happened
        node.running -= 1
        node.active.pop(task.task_id, None)
        rec = self.records[task.task_id]
        # a partitioned node computes the result but cannot return it to a
        # remote source; the source retries after the detection window
        result_lost = node.partitioned and node_name != task.source
        if rec.finished_ms == float("inf") and not rec.lost:
            if result_lost:
                self._push(now + self.cfg.detect_ms, self._retry, task)
            else:
                # first completion wins (a raced retry may finish later
                # elsewhere — that finish hits the branch above and is
                # dropped from accounting, though it did occupy its slot)
                self._n_done += 1
                rec.node = node_name
                if node_name == task.source:
                    rec.finished_ms = now
                else:
                    # result returns to the source over the link (T_re)
                    rec.finished_ms = now + \
                        node.profile.link.transfer_time(task.result_kb)
        # pull next waiting task (container goes back to the q queue)
        while node.waiting:
            _, _, nxt, enq = heapq.heappop(node.waiting)
            if self.policy.drop_late and \
               now - nxt.created_ms > nxt.constraint_ms:
                # shed late work — account it as dropped, not lost
                self.records[nxt.task_id].dropped = True
                self._n_done += 1
                continue
            self._start(now, node_name, nxt)
            break


def run_sim(policy: Policy, config: SimConfig, **kw) -> SimResult:
    return Simulator(policy, config, **kw).run()

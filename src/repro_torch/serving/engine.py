"""Serving engine: continuous-batching inference driven by the DDS core.

The port of ``repro.serving.engine`` in ring mode.  The architecture is the
JAX package's:

  * each **replica** = weights + a batched KV ring per decode lane + a
    background decode thread: the "warm container".  Construction runs
    every path once (whole-prompt prefill, each chunk bucket, insert, both
    decode steps, first-token sampling), so the kernels are built and
    loaded before the first request;
  * the **router** is the paper's two-level DDS: requests carry SLO
    deadlines; placement uses profile-predicted T_task over the replicas'
    telemetry, local-first when the origin replica can meet the deadline.
    Profiles are *measured* (``profile_replica`` times the batched
    ``decode_step`` at every occupancy and one chunk of prefill), and the
    decode loop keeps feeding live (occupancy, step_ms) samples into
    ``AppProfile.observe_step``: the paper's Update-Profile loop;
  * each replica runs **continuous batching**: one thread owns the batched
    KV cache with ``slots`` lanes and a per-lane position vector; requests
    join and leave between decode steps.  Every step is ONE batched
    ``decode_step`` over all lanes, with a single ``(slots,)`` token
    transfer to the host per step.  Prompt prefill is chunked in exact
    power-of-two buckets and interleaved between decode steps, with an
    SLO-adaptive token budget;
  * token selection is **per-lane** (temperature / top-k / top-p / seed on
    the ``Request``), greedy and sampled lanes mixing in one step
    (``repro_torch.serving.sampling``).

What differs from the JAX engine: the ``jax.jit`` executables are plain
eager calls (kernels are built at first use, during warmup); every timing
sample synchronises the device first (``torch.cuda.synchronize``) so it
measures the work and not its launch; the caches are updated in place.
Paged KV (``paged=True``) and sharded replicas (``serving_mesh``) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import bisect
import logging
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.core.admission import admit
from repro_torch.core.latency import (NodeState, Task, predict_process_ms,
                                      predict_queue_ms, predict_total_ms)
from repro_torch.core.policies import LOCAL, NodeView, Policy
from repro_torch.core.profile import (AppProfile, Curve, DeviceProfile,
                                      LinkProfile)
from repro_torch.core.telemetry import (MaintainProfileTable,
                                        UpdateProfilePublisher)
from repro_torch.ft.monitor import FleetMonitor
from repro_torch.models import model as model_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.overload import (BrownoutConfig, BrownoutController,
                                          CircuitBreaker, priority_rank)

log = logging.getLogger(__name__)


class ReplicaFailure(RuntimeError):
    """One replica attempt failed in a way the router may retry: the
    request itself is fine, the placement was not.  ``partial`` carries
    whatever tokens decoded before the failure (diagnostics only — a
    greedy/seeded retry regenerates the identical stream from scratch, so
    failover output never mixes two replicas' partial streams)."""

    def __init__(self, replica: str, msg: str,
                 partial: Optional[List[int]] = None):
        super().__init__(msg)
        self.replica = replica
        self.partial = partial or []


class ReplicaDead(ReplicaFailure):
    """The replica was declared dead (crashed decode thread, partitioned
    heartbeats, or a stalled executable) with this request in flight."""


class ReplicaRefused(ReplicaFailure):
    """The replica refused the request at submit time (draining/stopped) —
    an accounted refusal, retry elsewhere after backoff."""


class ReplicaSaturated(ReplicaFailure):
    """The replica shed this request under overload — a bounded-queue
    eviction or the deadline-aware queue sweep.  Unlike ``ReplicaDead`` /
    ``ReplicaRefused`` this is a *terminal, accounted* outcome (``shed``),
    not a retry signal: under fleet-wide overload every survivor sees the
    same pressure, and retrying would convert shed work into retry load on
    exactly the replicas that need relief.  ``retry_after_ms`` is the
    profile-derived hint for when the client should resubmit (predicted
    time for the current backlog to drain)."""

    def __init__(self, replica: str, msg: str,
                 partial: Optional[List[int]] = None,
                 retry_after_ms: float = 0.0):
        super().__init__(replica, msg, partial)
        self.retry_after_ms = retry_after_ms


class ReplicaLeak(RuntimeError):
    """stop() could not join the decode thread: it is hung, not stopped."""


@dataclass
class Request:
    """One serving request: a prompt, a decode budget, an SLO deadline —
    and per-request sampling + stop knobs.  ``temperature <= 0`` (the
    default) means greedy; otherwise tokens are drawn from the
    temperature-scaled, top-k/top-p-filtered distribution with a PRNG
    stream rooted at ``seed`` (default: the request id), so a fixed seed
    reproduces the exact token stream regardless of batch traffic.

    Stop conditions: generation ends early when the model emits
    ``eos_id`` or completes any of ``stop_sequences`` (token-id tuples);
    the matched token(s) are trimmed from the output and the lane is
    freed immediately — the next waiting request claims it on the very
    next loop iteration, not after the dead lane burns out its budget."""

    request_id: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    deadline_ms: float              # SLO: end-to-end completion deadline
    created_ms: float = 0.0
    enc: Optional[np.ndarray] = None
    temperature: float = 0.0        # <= 0: greedy
    top_k: int = 0                  # 0: disabled
    top_p: float = 1.0              # >= 1: disabled
    seed: Optional[int] = None      # PRNG root; None -> request_id
    eos_id: Optional[int] = None    # stop (and trim) on this token
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    priority: str = "interactive"   # overload class: queues order
                                    # (priority, deadline) and shedding
                                    # drops the lowest class first


@dataclass
class RequestResult:
    """Outcome of one ``ServingFleet.submit``.  Failure is explicit, never
    silent — and *classified* (docs/FAULTS.md failure taxonomy):

      * ``outcome="ok"`` — tokens delivered (``error`` is None);
      * ``outcome="rejected"`` — admission turned the request away before
        placement: its deadline sits below the fleet's measured
        feasibility floor (the paper's minimum-time-constraint rule);
      * ``outcome="shed"`` — an overloaded replica dropped it from the
        queue (bounded-queue eviction or the deadline sweep);
        ``retry_after_ms`` hints when to resubmit;
      * ``outcome="lost"`` — every placement attempt failed (replica
        death / refusals exhausted retries).

    ``attempts`` counts placements tried (>1 means the request was
    re-routed at least once), ``failed_over`` marks completion on a replica
    other than the first placement, ``ttft_ms`` is time to first token
    (0.0 when none decoded), and ``degraded`` marks a response served
    under brownout (clamped decode budget)."""

    request_id: int
    tokens: np.ndarray
    finished_ms: float
    replica: str
    created_ms: float
    attempts: int = 1
    failed_over: bool = False
    error: Optional[str] = None
    outcome: str = "ok"             # ok | rejected | shed | lost
    priority: str = "interactive"
    ttft_ms: float = 0.0
    retry_after_ms: float = 0.0
    degraded: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None

    def latency_ms(self) -> float:
        return self.finished_ms - self.created_ms

    def met(self, deadline_ms: float) -> bool:
        return self.ok and self.latency_ms() <= deadline_ms


class _Job:
    """One request's life inside the batched decoder."""

    __slots__ = ("req", "lane", "lane_cache", "consumed", "out", "remaining",
                 "done", "key", "stops", "error", "order", "first_ms",
                 "degraded")

    def __init__(self, req: Request):
        self.req = req
        self.lane: int = -1
        self.lane_cache = None          # B=1 cache being chunk-prefilled
        self.consumed = 0               # prompt tokens prefilled so far
        self.out: List[int] = []
        self.remaining = req.max_new_tokens
        self.done = threading.Event()
        self.error: Optional[ReplicaFailure] = None   # set before done on failure
        # queue order: (priority rank, absolute deadline, arrival seq)
        self.order: Tuple[int, float, int] = (0, 0.0, 0)
        self.first_ms = 0.0             # wall-clock of the first token (TTFT)
        self.degraded = False           # admitted under brownout clamping
        # per-lane key (seed, token count): derived only from the request,
        # advanced once per token
        self.key = (sampling_lib.make_lane_key(
            req.seed if req.seed is not None else req.request_id)
            if req.temperature > 0.0 else None)
        self.stops = [list(s) for s in req.stop_sequences if len(s) > 0]

    @property
    def sampled(self) -> bool:
        return self.key is not None

    def hit_stop(self) -> bool:
        """True if the last emitted token was ``eos_id`` or completed a
        stop sequence; the matched token(s) are trimmed from ``out``."""
        if (self.req.eos_id is not None and self.out
                and self.out[-1] == self.req.eos_id):
            self.out.pop()
            return True
        for s in self.stops:
            if len(self.out) >= len(s) and self.out[-len(s):] == s:
                del self.out[-len(s):]
                return True
        return False


class Replica:
    """One model replica: a persistent multi-lane batched decoder.

    A background thread owns the batched KV cache (``slots`` lanes, each a
    ``capacity``-deep ring) and loops:

      1. admit: waiting requests claim free lanes (EDF queue, shed sweep);
      2. prefill one chunk of at most one admitted prompt into its private
         B=1 lane cache, sized by the SLO budget;
      3. decode: one batched step over ALL lanes with the per-lane index
         vector; argmax for an all-greedy batch, per-lane sampling when any
         active lane has ``temperature > 0``; one ``(slots,)`` host
         transfer; finished lanes retire and free their slot.

    ``params`` is the ``Model`` the replica serves; replicas may share one
    (its tensors are only read).  The replica runs on the model's device.
    Knobs as in the JAX engine: ``slots``, ``capacity``,
    ``prefill_chunk_tokens`` (the budget ceiling, rounded down to a power
    of two and clamped to ``chunked_prefill_caps``), ``step_slo_ms``,
    ``max_queue`` and ``brownout``.  Counters for the launch accounting:
    ``decode_steps``, ``prefill_chunks``, ``whole_prefills`` and
    ``prefilled_tokens``.
    """

    def __init__(self, name: str, cfg: ModelConfig, params, *,
                 slots: int = 2, capacity: int = 256,
                 prefill_chunk_tokens: int = 32, step_slo_ms: float = 0.0,
                 max_queue: Optional[int] = None,
                 brownout: Optional[BrownoutConfig] = None,
                 paged: bool = False, serving_mesh=None):
        if paged:
            raise NotImplementedError(
                "paged KV is not ported yet: ROADMAP.md section 2 item 1")
        if serving_mesh is not None:
            raise NotImplementedError(
                "sharded replicas are not ported yet: ROADMAP.md section 2 "
                "item 6")
        self.name = name
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.capacity = capacity
        self.slots = slots
        self.step_slo_ms = float(step_slo_ms)
        self.max_queue = int(max_queue) if max_queue is not None \
            else 4 * slots
        if brownout is not None and brownout.step_slo_ms <= 0.0:
            brownout = replace(brownout, step_slo_ms=self.step_slo_ms)
        self.brownout = BrownoutController(brownout) \
            if brownout is not None else None
        self.prefill_caps = model_lib.chunked_prefill_caps(cfg, capacity)
        requested = max(min(int(prefill_chunk_tokens),
                            self.prefill_caps["max_chunk_tokens"]), 1)
        # exact chunk widths come from this power-of-two bucket set: any
        # budget decomposes into buckets with no padding
        self._chunk_buckets = [1]
        while self._chunk_buckets[-1] * 2 <= requested:
            self._chunk_buckets.append(self._chunk_buckets[-1] * 2)
        self.prefill_chunk_tokens = self._chunk_buckets[-1]
        self.decode_steps = 0           # batched decode steps served
        self.prefill_chunks = 0         # chunk launches
        self.whole_prefills = 0         # whole-prompt prefills on the lanes
        self.prefilled_tokens = 0       # prompt tokens actually computed
        self.profile: Optional[AppProfile] = None
        self.device_profile: Optional[DeviceProfile] = None

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: List[_Job] = []
        self._prefilling: deque = deque()       # _Job with a reserved lane
        self._seq = 0
        self._lanes: List[Optional[_Job]] = [None] * slots
        self._shutdown = False
        self._accepting = True
        self._last_progress_ms = time.monotonic() * 1e3

        # host mirrors: next token, KV index, key and sampling knobs per lane
        self._tok = np.zeros((slots, 1), np.int64)
        self._idx = np.zeros((slots,), np.int32)
        self._keys = np.zeros((slots, 2), np.int64)
        self._temp = np.zeros((slots,), np.float32)
        self._topk = np.zeros((slots,), np.int32)
        self._topp = np.ones((slots,), np.float32)

        # warm every path once: kernels build and load HERE, not on requests
        t0 = time.perf_counter()
        dummy = torch.zeros((1, 8), dtype=torch.int64, device=self.device)
        _, lane_cache = self._prefill(params, dummy)
        if self.prefill_caps["supported"]:
            lane0 = model_lib.init_cache(cfg, 1, capacity, self.device)
            start = 0
            for w in self._chunk_buckets:
                self._prefill_chunk(params, lane0, self._zeros_tokens(w),
                                    start)
                start += w
        self._cache = model_lib.init_cache(cfg, slots, capacity, self.device)
        self._insert(self._cache, lane_cache, 0)
        self._step(params, self._cache, self._tok, self._idx).cpu()
        self._step_sampled(params, self._cache, self._tok, self._idx,
                           self._keys, self._temp, self._topk,
                           self._topp)[0].cpu()
        self._sample_first(
            np.zeros((1, 2), np.int64),
            torch.zeros((1, cfg.vocab_size), device=self.device),
            np.ones((1,), np.float32), np.zeros((1,), np.int32),
            np.ones((1,), np.float32))[1].cpu()
        self._cache = model_lib.init_cache(cfg, slots, capacity, self.device)
        self._sync()
        self.warmup_s = time.perf_counter() - t0

        self._thread = threading.Thread(
            target=self._loop, name=f"decode-{name}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ executables
    def _sync(self) -> None:
        """Wait for the device, so a host clock reads the work itself."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _zeros_tokens(self, w: int) -> torch.Tensor:
        return torch.zeros((1, w), dtype=torch.int64, device=self.device)

    def _prefill(self, params, toks):
        return model_lib.prefill(params, toks, self.cfg, self.capacity)

    def _prefill_chunk(self, params, cache, toks, start: int):
        return model_lib.prefill_chunk(params, cache, toks, start, self.cfg)

    def _decode(self, params, cache, tok, idx):
        return model_lib.decode_step(params, cache, tok, idx, self.cfg)

    def _lane_inputs(self, tok, idx):
        return (torch.from_numpy(tok).to(self.device),
                torch.from_numpy(idx).to(self.device))

    def _step(self, params, cache, tok, idx):
        """One batched greedy decode step over all lanes (host tok/idx
        mirrors in, device (slots,) tokens out); the cache is updated in
        place."""
        logits, _ = model_lib.decode_step(params, cache,
                                          *self._lane_inputs(tok, idx),
                                          self.cfg)
        return torch.argmax(logits[:, -1], dim=-1)

    def _step_sampled(self, params, cache, tok, idx, keys, temp, topk, topp):
        """One batched decode step with per-lane sampling: greedy lanes
        still take the argmax, sampled lanes draw with their own key.
        Returns (tokens (slots,) on the device, next keys on the host)."""
        logits, _ = model_lib.decode_step(params, cache,
                                          *self._lane_inputs(tok, idx),
                                          self.cfg)
        keys, nxt = sampling_lib.sample_lane_tokens(keys, logits[:, -1],
                                                    temp, topk, topp)
        return nxt, keys

    def _sample_first(self, keys, logits, temp, topk, topp):
        return sampling_lib.sample_lane_tokens(keys, logits, temp, topk, topp)

    def _insert(self, cache, lane_cache, lane: int):
        """Copy a finished B=1 prefill cache into lane ``lane`` of the
        batched cache, in place.  The whole ring is overwritten, ``pos``
        included, so positions that decode steps ghost-wrote into the free
        lane never leak into the new request."""
        for dst, src in zip(cache, lane_cache):
            for name, t in dst.items():
                t[lane].copy_(src[name][0])
        return cache

    # -------------------------------------------------------------- serving
    @property
    def browned_out(self) -> bool:
        """True while the brownout controller has degradation engaged."""
        return self.brownout is not None and self.brownout.engaged

    def _retry_after_hint(self) -> float:
        """Profile-derived resubmit hint for a shed request: predicted time
        for the current backlog to drain through the lanes (queue waves x
        measured per-task decode time at full occupancy).  Caller holds
        the lock.  0.0 when the replica has no measured profile yet."""
        prof = self.profile
        if prof is None or prof.step_curve is None:
            return 0.0
        per_task = prof.tokens_per_task * prof.step_curve(float(self.slots))
        waves = (len(self._pending) + len(self._prefilling) + 1) \
            / max(self.slots, 1)
        return waves * per_task

    def generate_ex(self, req: Request) -> Tuple[np.ndarray, float, bool]:
        """Submit a request to the batched decoder and block for its tokens.
        Concurrent callers share decode steps, not a semaphore.

        Admission is bounded and deadline-ordered: the pending queue holds
        at most ``max_queue`` jobs sorted by (priority class, absolute
        deadline, arrival), and a full queue resolves in strict order — the
        *worst* job (the arrival itself, or a queued job it outranks) is
        shed with ``ReplicaSaturated`` + a retry-after hint, never blocked
        and never silently dropped.  Under brownout the admitted decode
        budget is clamped to the configured cap (the ``degraded`` flag in
        the return reports it).

        Returns ``(tokens, ttft_ms, degraded)``; ``ttft_ms`` is measured
        from ``req.created_ms`` (or enqueue, if the caller never stamped
        it) to the first emitted token."""
        if len(req.prompt) == 0:
            # reject in the CALLER's thread: an empty prompt reaching the
            # decode thread would kill it and strand every other lane
            raise ValueError(f"request {req.request_id}: empty prompt")
        job = _Job(req)
        now = time.monotonic() * 1e3
        born = req.created_ms or now
        evicted: Optional[_Job] = None
        with self._work:
            if self._shutdown or not self._accepting:
                raise ReplicaRefused(
                    self.name, f"replica {self.name} is "
                    f"{'stopped' if self._shutdown else 'not accepting'}")
            if (self.browned_out
                    and self.brownout.cfg.max_new_tokens_cap > 0
                    and job.remaining > self.brownout.cfg.max_new_tokens_cap):
                job.remaining = self.brownout.cfg.max_new_tokens_cap
                job.degraded = True
            self._seq += 1
            job.order = (priority_rank(req.priority),
                         born + req.deadline_ms, self._seq)
            if len(self._pending) >= self.max_queue:
                worst = max(self._pending, key=lambda j: j.order)
                if worst.order < job.order:
                    raise ReplicaSaturated(
                        self.name,
                        f"replica {self.name}: queue full "
                        f"({self.max_queue})",
                        retry_after_ms=self._retry_after_hint())
                # the arrival outranks the tail: evict the worst queued job
                self._pending.remove(worst)
                worst.error = ReplicaSaturated(
                    self.name,
                    f"replica {self.name}: queue full, evicted for a "
                    f"higher-priority/earlier-deadline arrival",
                    list(worst.out),
                    retry_after_ms=self._retry_after_hint())
                evicted = worst
            bisect.insort(self._pending, job, key=lambda j: j.order)
            self._last_progress_ms = time.monotonic() * 1e3
            self._work.notify()
        if evicted is not None:
            evicted.done.set()
        job.done.wait()
        if job.error is not None:
            raise job.error
        ttft = (job.first_ms - born) if job.first_ms > 0.0 else 0.0
        return np.asarray(job.out, np.int32), ttft, job.degraded

    def generate(self, req: Request) -> np.ndarray:
        """``generate_ex`` without the telemetry tuple (tokens only)."""
        return self.generate_ex(req)[0]

    def generate_sequential(self, req: Request) -> np.ndarray:
        """Batch-1 reference greedy decode: whole-prompt prefill, then one
        decode step per token with a host sync each.  The parity oracle."""
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.device)[None, :]
        logits, cache = self._prefill(self.params, prompt)
        out = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos = prompt.shape[1]
        for _ in range(req.max_new_tokens):
            out.append(int(tok[0, 0]))
            logits, cache = self._decode(self.params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos += 1
        return np.asarray(out, np.int32)

    def stop(self, timeout_s: float = 5.0, raise_on_leak: bool = True) -> bool:
        """Stop the decode thread and verify it actually exited.

        Returns True on a clean exit.  A decode thread that fails to join
        within ``timeout_s`` (hung executable, uninterruptible fault) is a
        LEAK, not a stop: it is logged and — unless ``raise_on_leak`` is
        False (monitor-thread use, where raising would kill detection) —
        surfaced as ``ReplicaLeak`` so a hung replica can never be
        silently "stopped"."""
        with self._work:
            self._shutdown = True
            self._accepting = False
            self._work.notify_all()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            msg = (f"replica {self.name}: decode thread failed to exit "
                   f"within {timeout_s:.1f}s — leaked, not stopped")
            log.error(msg)
            if raise_on_leak:
                raise ReplicaLeak(msg)
            return False
        return True

    def quiesce(self) -> List[Request]:
        """Stop accepting new requests and hand back the queued-but-not-
        started ones so the fleet can re-route them (the drain half of
        scale-in).  Jobs already prefilling or decoding keep their lanes —
        their streams finish here.  Queued jobs are failed with a
        retryable ``ReplicaRefused`` so their blocked callers re-enter the
        fleet's retry path instead of waiting on a replica that will never
        run them."""
        with self._work:
            self._accepting = False
            migrated = list(self._pending)
            self._pending.clear()
        for j in migrated:
            j.error = ReplicaRefused(
                self.name, f"replica {self.name} draining", list(j.out))
            j.done.set()
        return [j.req for j in migrated]

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Quiesce, then wait for every active lane (and in-progress
        prefill) to finish.  Returns True when the replica emptied within
        ``timeout_s`` — afterwards ``stop()`` cannot cut a live stream."""
        self.quiesce()
        deadline = time.monotonic() + timeout_s
        with self._work:
            while (any(j is not None for j in self._lanes)
                   or self._prefilling):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._work.wait(min(remaining, 0.05))
        return True

    def fail_inflight(self, reason: str = "replica dead") -> List[Request]:
        """Fail every in-flight job (queued, prefilling, decoding) with a
        retryable ``ReplicaDead`` and stop accepting — the eviction path
        the FleetMonitor runs when this replica is declared dead.  Blocked
        ``generate`` callers raise instead of hanging forever on a decode
        thread that will never set their event.  Returns the failed
        requests (the fleet re-submits them through routing)."""
        with self._work:
            self._accepting = False
            jobs = (list(self._pending) + list(self._prefilling)
                    + [j for j in self._lanes if j is not None])
            self._pending.clear()
            self._prefilling.clear()
            self._lanes = [None] * self.slots
        for j in jobs:
            j.error = ReplicaDead(
                self.name, f"replica {self.name}: {reason}", list(j.out))
            j.done.set()
        return [j.req for j in jobs]

    def stalled_ms(self, now_ms: Optional[float] = None) -> float:
        """Milliseconds since the decode loop last made progress while
        holding admitted work (0.0 when idle).  A crashed or hung decode
        thread keeps ``running`` lanes but stops advancing this clock —
        the progress signal the FleetMonitor reads, since a hung
        executable's heartbeat thread keeps publishing happily."""
        now = now_ms if now_ms is not None else time.monotonic() * 1e3
        with self._lock:
            busy = (any(j is not None for j in self._lanes)
                    or bool(self._prefilling) or bool(self._pending))
            if not busy:
                return 0.0
            return now - self._last_progress_ms

    # ---------------------------------------------------- decode loop (thread)
    def _loop(self) -> None:
        while True:
            with self._work:
                while (not self._shutdown and not self._pending
                       and not self._prefilling
                       and all(j is None for j in self._lanes)):
                    if self.browned_out:
                        # idle = pressure is gone: feed clear samples so
                        # brownout restores while parked
                        self.brownout.observe(0.0, 0)
                        self._work.wait(0.01)
                    else:
                        self._work.wait()
                if self._shutdown:
                    stranded = (list(self._pending) + list(self._prefilling)
                                + [j for j in self._lanes if j is not None])
                    self._lanes = [None] * self.slots
                    for j in stranded:
                        j.done.set()    # callers get whatever decoded so far
                    return
                # shed queued jobs whose predicted wait exceeds their slack,
                # then let waiting requests claim free lanes
                shed = self._shed_sweep_locked(time.monotonic() * 1e3)
                shed += self._admit_locked()
                active = [i for i, j in enumerate(self._lanes)
                          if j is not None]
                head = self._prefilling[0] if self._prefilling else None
            for j in shed:
                j.done.set()

            # one prefill chunk for the oldest admitted prompt, then one
            # decode step over every lane
            if head is not None:
                self._advance_prefill(head, len(active))
            if active:
                self._decode_step(active)

    def _shed_sweep_locked(self, now_ms: float) -> List[_Job]:
        """Walk the pending queue in order and drop every job whose
        predicted ``T_que + T_process`` exceeds its remaining deadline
        slack (the paper's predictor, pointed at our own queue).  Each
        job is priced at its *post-shed* queue position, so better-ranked
        jobs are evaluated against a queue that excludes the work shed
        ahead of them — shedding the tail is exactly what keeps the head
        feasible.  Caller holds the lock; caller must ``done.set()`` the
        returned jobs after releasing it."""
        if not self._pending:
            return []
        prof = self.profile
        if prof is None or prof.step_curve is None:
            return []                   # no measured profile: nothing to predict
        if self.device_profile is None:
            self.device_profile = DeviceProfile(
                self.name, self.slots, {"serve": prof})
        dev = self.device_profile
        running = sum(1 for j in self._lanes if j is not None)
        nres = len(self._prefilling)
        shed: List[_Job] = []
        keep: List[_Job] = []
        for job in self._pending:
            req = job.req
            slack = job.order[1] - now_ms       # absolute deadline - now
            task = Task(task_id=req.request_id, app_id="serve",
                        size_kb=float(len(req.prompt)), created_ms=0.0,
                        constraint_ms=req.deadline_ms)
            state = NodeState(running=running, queued=len(keep),
                              reserved=nres)
            t = (predict_queue_ms(dev, task, state)
                 + predict_process_ms(dev, task, state))
            (shed if t > slack else keep).append(job)
        if shed:
            self._pending = keep
            hint = self._retry_after_hint()
            for job in shed:
                job.error = ReplicaSaturated(
                    self.name,
                    f"replica {self.name}: shed {job.req.priority} request "
                    f"{job.req.request_id} (predicted wait exceeds "
                    f"deadline slack)", list(job.out), retry_after_ms=hint)
        return shed

    def _admit_locked(self) -> List[_Job]:
        """Claim free lanes for waiting requests in queue order (caller
        holds the lock).  Returns the jobs shed on the way (none in ring
        mode; the caller sets their done events outside the lock)."""
        reserved = {j.lane for j in self._prefilling}
        free = [l for l in range(self.slots)
                if self._lanes[l] is None and l not in reserved]
        while free and self._pending:
            job = self._pending.pop(0)
            job.lane = free.pop(0)
            self._prefilling.append(job)
        return []

    def budget_tokens(self, occupancy: int) -> int:
        """SLO-adaptive prefill budget for one interleave slot: how many
        prompt tokens may prefill between this decode step and the next.

        With no SLO (``step_slo_ms <= 0``), no active decode lanes to
        stall, or no measured chunk cost yet, the ceiling
        (``prefill_chunk_tokens``) is granted.  Otherwise the budget is
        the SLO's slack over the measured step cadence at ``occupancy``
        (both live-EWMA'd by the Update-Profile loop), divided by the
        measured per-token chunk cost — floored at 1 token so admitted
        prompts always make progress (the SLO shrinks chunks; it cannot
        starve them).

        Under brownout the ceiling itself shrinks by the configured
        ``budget_factor`` — prefill is the deferrable work, so degrading
        it first protects the in-flight decode cadence."""
        mx = self.prefill_chunk_tokens
        if self.browned_out:
            mx = max(int(mx * self.brownout.cfg.budget_factor), 1)
        prof = self.profile
        if self.step_slo_ms <= 0.0 or occupancy <= 0 or prof is None:
            return mx
        per_tok = prof.prefill_ms_per_token()
        if per_tok <= 0.0 or prof.step_curve is None:
            return mx
        slack = self.step_slo_ms - prof.step_curve(float(occupancy))
        return int(max(min(slack / per_tok, float(mx)), 1.0))

    def _advance_prefill(self, job: _Job, occupancy: int = 0) -> None:
        prompt = job.req.prompt
        n = len(prompt)
        caps = self.prefill_caps
        bound = caps["max_prompt_tokens"]
        if not caps["supported"] or (bound is not None and n > bound):
            # single-shot prefill: prompts a global-attention ring cannot
            # hold in chunks
            toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                   device=self.device)[None, :]
            logits, job.lane_cache = self._prefill(self.params, toks)
            job.consumed = n
            self.whole_prefills += 1
            self.prefilled_tokens += n
        else:
            if job.lane_cache is None:
                job.lane_cache = model_lib.init_cache(self.cfg, 1,
                                                      self.capacity,
                                                      self.device)
            c = min(self.budget_tokens(occupancy), n - job.consumed)
            # largest bucket that fits the budget and the remaining prompt
            w = 1
            for bkt in self._chunk_buckets:
                if bkt <= c:
                    w = bkt
            buf = torch.as_tensor(
                np.asarray(prompt[job.consumed:job.consumed + w]),
                dtype=torch.int64, device=self.device)[None, :]
            t0 = time.perf_counter()
            logits, job.lane_cache = self._prefill_chunk(
                self.params, job.lane_cache, buf, job.consumed)
            prof = self.profile
            if prof is not None:
                # sync so the UP sample is the chunk's real time, not its
                # launch time
                self._sync()
                prof.observe_prefill_chunk((time.perf_counter() - t0) * 1e3,
                                           tokens=w)
            job.consumed += w
            self.prefill_chunks += 1
            self.prefilled_tokens += w
        self._last_progress_ms = time.monotonic() * 1e3
        if job.consumed < n:
            return
        # prompt fully prefilled: splice the lane in and emit token 0,
        # sampled from the prefill logits with the job's own key (one draw,
        # same discipline as every decode step), argmax otherwise
        if job.sampled:
            keys, tok0 = self._sample_first(
                job.key[None], logits[0, -1][None].float(),
                np.full((1,), job.req.temperature, np.float32),
                np.full((1,), job.req.top_k, np.int32),
                np.full((1,), job.req.top_p, np.float32))
            first = int(tok0[0])
            job.key = keys[0]
        else:
            first = int(torch.argmax(logits[0, -1]))
        self._insert(self._cache, job.lane_cache, job.lane)
        job.lane_cache = None
        lane = job.lane
        self._tok[lane, 0] = first
        self._idx[lane] = n
        # lane sampling state: recycled lanes inherit nothing
        if job.sampled:
            self._keys[lane] = job.key
            self._temp[lane] = job.req.temperature
            self._topk[lane] = job.req.top_k
            self._topp[lane] = job.req.top_p
        else:
            self._keys[lane] = 0
            self._temp[lane] = 0.0
            self._topk[lane] = 0
            self._topp[lane] = 1.0
        finished = False
        with self._work:
            if self._prefilling and self._prefilling[0] is job:
                self._prefilling.popleft()
            self._work.notify_all()         # wake drain() waiters
            if job.error is not None:
                return                      # failed/evicted mid-prefill
            if job.remaining > 0:
                job.out.append(first)
                job.first_ms = time.monotonic() * 1e3   # TTFT stamp
                job.remaining -= 1
                if job.hit_stop():          # eos/stop on the very first token
                    job.remaining = 0
            if job.remaining == 0:
                finished = True
            else:
                self._lanes[lane] = job
        if finished:
            # the job never joins the batch: leave the lane greedy
            self._temp[lane] = 0.0
            self._topk[lane] = 0
            self._topp[lane] = 1.0
            job.done.set()

    def _decode_step(self, active: List[int]) -> None:
        t0 = time.perf_counter()
        # an all-greedy batch takes the argmax-only step; any sampled active
        # lane switches the whole step to per-lane sampling
        if any(self._temp[lane] > 0.0 for lane in active):
            nxt, keys = self._step_sampled(
                self.params, self._cache, self._tok, self._idx, self._keys,
                self._temp, self._topk, self._topp)
            # keep the keys of ACTIVE lanes only: a lane that joined after
            # `active` was taken had this step's token discarded, so its
            # count must not advance
            for lane in active:
                self._keys[lane] = keys[lane]
        else:
            nxt = self._step(self.params, self._cache, self._tok, self._idx)
        nxt_np = nxt.cpu().numpy()      # the one (slots,) transfer per step
        self.decode_steps += 1
        self._last_progress_ms = time.monotonic() * 1e3
        step_ms = (time.perf_counter() - t0) * 1e3
        prof = self.profile             # Update-Profile: live step telemetry
        if prof is not None:
            prof.observe_step(len(active), step_ms)
        finished: List[_Job] = []
        with self._work:
            if self.brownout is not None:
                self.brownout.observe(
                    step_ms, len(self._pending) + len(self._prefilling))
            for lane in active:
                job = self._lanes[lane]
                if job is None:
                    continue
                job.out.append(int(nxt_np[lane]))
                job.remaining -= 1
                self._tok[lane, 0] = nxt_np[lane]
                self._idx[lane] += 1
                if job.hit_stop():
                    job.remaining = 0
                if job.remaining == 0:
                    self._lanes[lane] = None
                    # freed lanes must not keep forcing the sampled path
                    self._temp[lane] = 0.0
                    self._topk[lane] = 0
                    self._topp[lane] = 1.0
                    finished.append(job)
            if finished:
                self._work.notify_all()     # wake drain() waiters
        for job in finished:
            job.done.set()

    # ------------------------------------------------------------ telemetry
    def state(self) -> NodeState:
        """Lane occupancy of the shared decode batch (not semaphore counts):
        ``running`` = lanes actively decoding, ``reserved`` = lanes held by
        an in-progress prefill, ``queued`` = requests still waiting for a
        lane.  Prefilling jobs live in ``reserved`` ONLY — counting them in
        ``queued`` too made every consumer double-charge them (capacity
        math subtracted them and T_que priced them as waiting work).
        ``brownout`` rides along so the Update-Profile heartbeat advertises
        degradation honestly to routing."""
        with self._lock:
            running = sum(1 for j in self._lanes if j is not None)
            reserved = len(self._prefilling)
            queued = len(self._pending)
        return NodeState(running=running, queued=queued, reserved=reserved,
                         brownout=self.browned_out,
                         updated_ms=time.monotonic() * 1e3)

    def free_slots(self) -> int:
        """Lanes not occupied or reserved by an in-progress prefill.
        Queued requests wait for a lane but do not *hold* one — their cost
        is priced by the T_que predictor, not subtracted from capacity."""
        with self._lock:
            occupied = sum(1 for j in self._lanes if j is not None)
            occupied += len(self._prefilling)
            return max(self.slots - occupied, 0)




def measure_step_curve(rep: Replica, steps_per_point: int = 6,
                       warmup_steps: int = 2) -> Tuple[List[float], List[float], float]:
    """Time the batched ``decode_step`` at every lane occupancy 1..slots.

    Runs the replica's own ``_step`` over a *scratch* cache (never the live
    one), with the first ``n`` lanes at a non-zero position, and takes the
    best of ``steps_per_point`` wall-clock samples per occupancy, each
    ending in a device synchronise.  Also times one ``prefill_chunk`` of the
    widest bucket: the cost a joining prompt interleaves between decode
    steps.  Call before serving traffic.

    Returns ``(occupancies, step_ms, prefill_chunk_ms)``.
    """
    cache = model_lib.init_cache(rep.cfg, rep.slots, rep.capacity, rep.device)
    tok = np.zeros((rep.slots, 1), np.int64)
    pos = min(16, rep.capacity - 1)
    occs, step_ms = [], []
    for n in range(1, rep.slots + 1):
        idx = np.where(np.arange(rep.slots) < n, pos, 0).astype(np.int32)
        best = float("inf")
        for i in range(warmup_steps + steps_per_point):
            t0 = time.perf_counter()
            rep._step(rep.params, cache, tok, idx)
            rep._sync()
            dt = (time.perf_counter() - t0) * 1e3
            if i >= warmup_steps:
                best = min(best, dt)
        occs.append(float(n))
        step_ms.append(best)

    chunk_ms = 0.0
    if rep.prefill_caps["supported"]:
        lane = model_lib.init_cache(rep.cfg, 1, rep.capacity, rep.device)
        buf = rep._zeros_tokens(rep._chunk_buckets[-1])
        best = float("inf")
        for i in range(1 + steps_per_point):
            t0 = time.perf_counter()
            rep._prefill_chunk(rep.params, lane, buf, 0)
            rep._sync()
            if i >= 1:
                best = min(best, (time.perf_counter() - t0) * 1e3)
        chunk_ms = best
    return occs, step_ms, chunk_ms


def profile_replica(rep: Replica, prompt_lens=(8, 32, 128),
                    new_tokens: int = 8,
                    steps_per_point: int = 6) -> AppProfile:
    """Measure this replica's latency profile (the paper's pre-evaluation):
    prompt length plays the role of image-KB.  The base point is the
    single-lane latency; contention is the measured step curve
    (``measure_step_curve``), so the profile is in lane mode and the DDS
    predictor charges a joining request its prefill plus the measured step
    cadence at the post-join occupancy.  The size curve is measured
    whole-prompt prefill time plus ``new_tokens`` steps at the measured
    batched cadence."""
    occs, step_ms, chunk_ms = measure_step_curve(rep, steps_per_point)
    times = []
    for s in prompt_lens:
        toks = torch.ones((1, s), dtype=torch.int64, device=rep.device)
        rep._prefill(rep.params, toks)
        best = float("inf")
        for _ in range(2):
            rep._sync()
            t0 = time.perf_counter()
            rep._prefill(rep.params, toks)
            rep._sync()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        times.append(best + new_tokens * step_ms[0])
    base = times[0]
    cont = [base + new_tokens * max(m - step_ms[0], 0.0) for m in step_ms]
    return AppProfile(
        app_id="serve", base_ms=base,
        contention=Curve(list(occs), cont),
        size_curve=Curve([float(s) for s in prompt_lens], times),
        reference_size=float(prompt_lens[0]),
        step_curve=Curve(list(occs), list(step_ms)),
        tokens_per_task=float(new_tokens),
        prefill_chunk_ms=chunk_ms,
        # the chunk width chunk_ms was measured at (the widest bucket)
        prefill_chunk_tokens=float(rep._chunk_buckets[-1]
                                   if rep.prefill_caps["supported"] else 0))


class ServingFleet:
    """DDS router over replicas.  ``source`` is the replica co-located with
    the request origin (paper: Rasp1 next to the camera).

    Telemetry flows the paper's way: every replica runs an
    ``UpdateProfilePublisher`` heartbeat that snapshots its (live-EWMA'd)
    profile plus lane occupancy into the coordinator's
    ``MaintainProfileTable``; routing reads *that* staleness-tolerant
    table, not live replica state — level 1 (the source's own decision)
    and the coordinator's self-view stay exact, peers are table views, so
    the router scales without fanning a state RPC per request.

    ``submit(req)`` is the whole client API: the ``Request`` carries the
    prompt, the SLO deadline, and the per-request sampling knobs
    (temperature / top_k / top_p / seed), which ride through routing
    untouched and bind to whichever replica lane the request lands on.
    The router only ever sees the replicas' lane-mode profiles and
    occupancy telemetry.

    **Failure handling** (the paper's "dynamically varying environment"):
    a ``FleetMonitor`` polls the MP table's staleness alarm — derived
    from ``heartbeat_ms`` (``staleness_factor`` heartbeats), never the
    1000 ms training default — plus each replica's decode-progress clock
    (a hung executable heartbeats happily).  A replica declared dead is
    evicted from routing and its in-flight requests are failed with a
    retryable error; their blocked ``submit`` callers then re-route —
    re-prefilling from scratch, so greedy/seeded streams stay
    token-identical — but only while a surviving replica's predicted
    ``T_task`` (queue + process) still fits the remaining deadline slack,
    with at most ``max_attempts`` placements and jittered backoff between
    them.  Requests that exhaust retries return a ``RequestResult`` with
    ``error`` set and are counted in ``lost`` — visible, never silent.
    ``remove_replica`` drains by default: the replica stops accepting,
    active lanes finish their streams, queued requests re-route."""

    def __init__(self, policy: Policy, source: str, coordinator: str,
                 heartbeat_ms: float = 20.0, staleness_factor: float = 25.0,
                 progress_timeout_ms: float = 5_000.0, max_attempts: int = 3,
                 retry_backoff_ms: float = 20.0, monitor: bool = True,
                 admission_margin: float = 1.0,
                 breaker_threshold: int = 3, breaker_open_ms: float = 500.0,
                 seed: int = 0):
        self.policy = policy
        self.source = source
        self.coordinator = coordinator
        self.heartbeat_ms = heartbeat_ms
        # the staleness alarm is a MULTIPLE of the configured heartbeat —
        # wiring the table's 1000 ms default under a 20 ms heartbeat made
        # the alarm 50 periods wide for one fleet and 1 period for another
        if staleness_factor < 2.0:
            raise ValueError(
                f"staleness_factor={staleness_factor} < 2: a single missed "
                "heartbeat would declare the replica dead")
        self.staleness_alarm_ms = staleness_factor * heartbeat_ms
        self.progress_timeout_ms = progress_timeout_ms
        self.max_attempts = max(int(max_attempts), 1)
        self.retry_backoff_ms = retry_backoff_ms
        self.replicas: Dict[str, Replica] = {}
        self.profiles: Dict[str, DeviceProfile] = {}
        self.table = MaintainProfileTable(
            staleness_alarm_ms=self.staleness_alarm_ms)
        assert self.table.staleness_alarm_ms >= 2 * heartbeat_ms
        self._publishers: Dict[str, UpdateProfilePublisher] = {}
        self.stats: Dict[str, int] = {}
        self.failovers = 0               # requests re-routed off a dead replica
        self.lost = 0                    # requests reported failed (visible!)
        self.rejected = 0                # admission-rejected (infeasible SLO)
        self.shed = 0                    # overload-shed by a replica queue
        self.dead: List[str] = []        # replicas the monitor evicted
        # admission: deadline must clear the fleet's measured feasibility
        # floor x margin (paper's minimum-time-constraint rule); <= 0
        # disables the gate
        self.admission_margin = float(admission_margin)
        # per-replica circuit breakers: repeated dead/refused failures stop
        # retry traffic from re-slamming a sick replica
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_open_ms = float(breaker_open_ms)
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._rng = random.Random(seed)  # retry-backoff jitter
        self._lock = threading.Lock()    # guards membership dicts + stats
        self.monitor: Optional[FleetMonitor] = None
        if monitor:
            self.monitor = FleetMonitor(
                self.table, on_dead=self._on_replica_dead,
                poll_ms=heartbeat_ms, stalled_fn=self._stalled_replicas)
            self.monitor.start()

    def add_replica(self, rep: Replica, profile: Optional[AppProfile] = None,
                    link: Optional[LinkProfile] = None) -> None:
        # a recycled name must not inherit the dead incarnation's MP-table
        # record (profile, occupancy): drop any stale row
        # so the only state routing ever sees for the new process is its
        # own first heartbeat
        self.table.remove(rep.name)
        prof = profile or profile_replica(rep)
        rep.profile = prof              # decode loop feeds the UP loop
        dev = DeviceProfile(
            rep.name, rep.slots, {"serve": prof},
            link or LinkProfile(bandwidth_kbps=1e6, rtt_ms=0.2))
        rep.device_profile = dev        # shed sweep prices its own queue
        pub = UpdateProfilePublisher(rep.name, dev, rep.state, self.table,
                                     self.heartbeat_ms)
        with self._lock:
            self.replicas[rep.name] = rep
            self.profiles[rep.name] = dev
            self._publishers[rep.name] = pub
            self.breakers[rep.name] = CircuitBreaker(
                self.breaker_threshold, self.breaker_open_ms)
        if self.monitor is not None:
            self.monitor.revive(rep.name)   # a rejoin clears prior death
        pub.start()

    def remove_replica(self, name: str, drain: bool = True) -> None:
        """Scale a replica out.  With ``drain`` (the default) this is
        graceful: the replica stops accepting, queued requests are failed
        retryable (their blocked callers re-route through ``submit``'s
        retry loop), active lanes finish their streams, and only then does
        the decode thread stop — no dropped streams on scale-in.  With
        ``drain=False`` it is an immediate teardown (fleet shutdown)."""
        with self._lock:
            pub = self._publishers.pop(name, None)
            self.profiles.pop(name, None)
            rep = self.replicas.pop(name, None)
            self.breakers.pop(name, None)
        if pub:
            pub.stop()
        self.table.remove(name)
        if rep:
            if drain and not rep.drain():
                log.warning("replica %s: drain timed out; stopping with "
                            "lanes still active", name)
            rep.stop()

    def stop(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        with self._lock:
            names = list(self.replicas)
        for name in names:
            self.remove_replica(name, drain=False)

    # ------------------------------------------------------ failure handling
    def _stalled_replicas(self) -> List[str]:
        """Replicas whose decode loop holds work but has not advanced for
        ``progress_timeout_ms`` — the hang detector (a hung executable's
        heartbeat thread keeps publishing, so staleness alone misses it)."""
        if self.progress_timeout_ms <= 0:
            return []
        with self._lock:
            reps = dict(self.replicas)
        return [n for n, r in reps.items()
                if r.stalled_ms() > self.progress_timeout_ms]

    def _on_replica_dead(self, name: str, reason: str) -> None:
        """Monitor callback: evict ``name`` from routing and fail its
        in-flight requests retryable.  Ordering matters — fail_inflight
        BEFORE stop(): the decode loop's shutdown path releases stranded
        jobs with partial tokens and *no* error, which would silently
        truncate streams instead of re-routing them."""
        with self._lock:
            pub = self._publishers.pop(name, None)
            self.profiles.pop(name, None)
            rep = self.replicas.pop(name, None)
            self.breakers.pop(name, None)
            if rep is not None:
                self.dead.append(name)
        if pub:
            pub.stop()
        self.table.remove(name)
        if rep is None:
            return                      # already removed (drain raced death)
        failed = rep.fail_inflight(reason)
        # best-effort teardown: never raise in the monitor thread (a hung
        # decode thread is exactly what got us here)
        rep.stop(timeout_s=1.0, raise_on_leak=False)
        log.warning("replica %s declared dead (%s); %d in-flight request(s) "
                    "re-routed", name, reason, len(failed))

    def _members(self) -> Dict[str, Replica]:
        """Membership snapshot — routing must never iterate or index the
        live dicts while remove_replica mutates them (same hardening as
        core Fleet.submit)."""
        with self._lock:
            return dict(self.replicas)

    def _view(self, name: str, rep: Replica, exact: bool = False) -> NodeView:
        prof = self.profiles.get(name)
        if prof is None:                # removed mid-route: live fallback
            prof = DeviceProfile(name, rep.slots,
                                 {"serve": rep.profile} if rep.profile else {})
        if exact:
            return NodeView(profile=prof, state=rep.state(),
                            free_slots=rep.free_slots())
        rec = self.table.get(name)
        if rec is None:                 # no heartbeat yet: fall back to live
            return NodeView(profile=prof, state=rep.state(),
                            free_slots=rep.free_slots())
        # capacity = lanes minus occupied and reserved (mid-prefill) lanes;
        # queued jobs hold no lane and are priced by T_que — subtracting
        # them here double-counted prefilling jobs and under-reported
        # free capacity to routing
        free = max(rep.slots - rec.state.running - rec.state.reserved, 0)
        return NodeView(profile=rec.profile, state=rec.state, free_slots=free)

    def route(self, req: Request) -> str:
        """Two-level DDS placement; returns chosen replica name."""
        members = self._members()
        return self._route(req, members)

    def _route(self, req: Request, members: Dict[str, Replica],
               avoid: Optional[str] = None) -> str:
        """Two-level placement over the surviving membership.  ``avoid``
        biases a retry away from the replica that just failed the request
        (it may already be evicted; if it is the only survivor, it is
        still used).  When the named source/coordinator replica has died,
        routing promotes a survivor instead of refusing — churn must not
        take down the whole fleet because a *special* replica died."""
        if avoid is not None and len(members) > 1:
            members = {n: r for n, r in members.items() if n != avoid}
        if not members:
            raise ReplicaRefused("-", "no live replicas in the fleet")
        now = time.monotonic() * 1e3
        task = Task(task_id=req.request_id, app_id="serve",
                    size_kb=float(len(req.prompt)), created_ms=req.created_ms
                    or now, constraint_ms=req.deadline_ms, source=self.source)
        source = members.get(self.source)
        coordinator = members.get(self.coordinator)
        if coordinator is None:     # promote: source, else any survivor
            cname = self.source if source is not None \
                else sorted(members)[0]
            coordinator = members[cname]
        else:
            cname = self.coordinator
        if source is not None and self.policy.decide_source(
                task, now, self._view(self.source, source, exact=True)) == LOCAL:
            return self.source
        peers = {n: self._view(n, r) for n, r in members.items()
                 if n not in (cname, self.source)}
        return self.policy.decide_coordinator(
            task, now, self._view(cname, coordinator, exact=True), peers)

    def _retry_viable(self, req: Request, members: Dict[str, Replica]) -> bool:
        """Deadline-aware retry gate: re-route only when some survivor's
        predicted T_task still fits the remaining SLO slack (the paper's
        predictor, same as placement — retrying a request that cannot make
        its deadline anywhere just burns a lane a live request needs)."""
        now = time.monotonic() * 1e3
        slack = req.deadline_ms - (now - req.created_ms)
        if slack <= 0:
            return False
        task = Task(task_id=req.request_id, app_id="serve",
                    size_kb=float(len(req.prompt)), created_ms=req.created_ms,
                    constraint_ms=req.deadline_ms, source=self.source)
        for name in members:
            prof = self.profiles.get(name)
            if prof is None or "serve" not in prof.apps:
                continue
            view = self._view(name, members[name])
            t = predict_total_ms(view.profile, task, view.state,
                                 remote=(name != self.source))
            if t <= slack:
                return True
        return False

    def _backoff_s(self, attempt: int) -> float:
        """Jittered exponential backoff before retry ``attempt`` (1-based):
        refused submits must not re-slam the surviving replicas in
        lockstep."""
        base = self.retry_backoff_ms * (2.0 ** (attempt - 1))
        return base * (0.5 + 0.5 * self._rng.random()) / 1e3

    def degraded(self) -> List[str]:
        """Replicas currently advertising brownout through the UP
        heartbeat (the honest, staleness-tolerant view routing also
        sees)."""
        return self.table.degraded_nodes()

    def _admission_check(self, req: Request) -> Optional[RequestResult]:
        """Feasibility-floor admission (the paper's minimum-time-constraint
        rule): a deadline below the best-case T_task any replica could
        deliver — measured profiles, idle state — times the headroom
        margin is *rejected* in the caller's thread, before routing or
        queueing.  Returns the rejected result, or None to admit."""
        if self.admission_margin <= 0.0:
            return None
        task = Task(task_id=req.request_id, app_id="serve",
                    size_kb=float(len(req.prompt)),
                    created_ms=req.created_ms, constraint_ms=req.deadline_ms,
                    source=self.source)
        with self._lock:
            profiles = dict(self.profiles)
        ok, floor = admit(profiles, task, self.source, self.admission_margin)
        if ok:
            return None
        with self._lock:
            self.rejected += 1
        return RequestResult(
            req.request_id, np.asarray([], np.int32),
            time.monotonic() * 1e3, "-", req.created_ms, attempts=0,
            outcome="rejected", priority=req.priority,
            error=(f"deadline {req.deadline_ms:.0f}ms below feasibility "
                   f"floor {floor:.0f}ms (margin "
                   f"{self.admission_margin:g})"))

    def _shed_result(self, req: Request, e: ReplicaSaturated,
                     attempts: int) -> RequestResult:
        with self._lock:
            self.shed += 1
        return RequestResult(
            req.request_id, np.asarray([], np.int32),
            time.monotonic() * 1e3, e.replica, req.created_ms,
            attempts=attempts, outcome="shed", priority=req.priority,
            retry_after_ms=e.retry_after_ms, error=str(e))

    def submit(self, req: Request) -> RequestResult:
        """Admit, route, generate, and — on replica death or refusal —
        retry on a survivor while the deadline still allows, up to
        ``max_attempts`` placements.  Every return is a *classified*
        ``RequestResult`` (see its docstring / docs/FAULTS.md): admission
        rejects infeasible deadlines fast (never blocked, never counted
        lost), an overloaded replica's queue eviction or shed sweep comes
        back as a terminal ``shed`` with a retry-after hint (retrying
        would re-slam a saturated fleet), and per-replica circuit breakers
        take repeat offenders out of routing until a half-open probe
        heals them.

        Greedy and seeded-sampled decodes are deterministic functions of
        the request, so a failover retry regenerates the token-identical
        stream from scratch; partial tokens from the dead replica are
        never stitched.  Exhausted requests return an error result
        (``ok=False``, partial tokens attached) and count in ``lost`` —
        the failure mode is visible, never a hang or a silently truncated
        stream."""
        req.created_ms = req.created_ms or time.monotonic() * 1e3
        rejected = self._admission_check(req)
        if rejected is not None:
            return rejected
        attempts = 0
        first_name: Optional[str] = None
        last_err: Optional[ReplicaFailure] = None
        while attempts < self.max_attempts:
            attempts += 1
            members = self._members()
            # breaker gate: replicas in cooldown leave routing (unless
            # every member is — then routing proceeds and acquire() below
            # settles who, if anyone, gets the half-open probe)
            tripped = [n for n in members
                       if n in self.breakers
                       and not self.breakers[n].available()]
            if tripped and len(tripped) < len(members):
                members = {n: r for n, r in members.items()
                           if n not in tripped}
            avoid = last_err.replica if last_err is not None else None
            try:
                name = self._route(req, members, avoid=avoid)
            except ReplicaRefused as e:
                last_err = e
                break                   # no live replicas: nothing to wait for
            brk = self.breakers.get(name)
            if brk is not None and not brk.acquire():
                # breaker still open (or another thread won the probe
                # slot): spend the attempt elsewhere
                last_err = ReplicaRefused(
                    name, f"replica {name}: circuit breaker open")
                continue
            first_name = first_name or name
            with self._lock:
                self.stats[name] = self.stats.get(name, 0) + 1
                if attempts > 1:
                    self.failovers += 1
            try:
                toks, ttft, degraded = members[name].generate_ex(req)
                if brk is not None:
                    brk.on_success()
                return RequestResult(
                    req.request_id, toks, time.monotonic() * 1e3, name,
                    req.created_ms, attempts=attempts,
                    failed_over=(name != first_name),
                    priority=req.priority, ttft_ms=ttft, degraded=degraded)
            except ReplicaSaturated as e:
                # the replica answered (it is alive, just overloaded):
                # success for the breaker, terminal shed for the request
                if brk is not None:
                    brk.on_success()
                return self._shed_result(req, e, attempts)
            except ReplicaFailure as e:
                if brk is not None:
                    brk.on_failure()
                last_err = e
                log.info("request %d attempt %d on %s failed: %s",
                         req.request_id, attempts, name, e)
                if attempts >= self.max_attempts:
                    break
                time.sleep(self._backoff_s(attempts))
                if not self._retry_viable(req, self._members()):
                    log.info("request %d: no survivor fits remaining "
                             "deadline slack; giving up", req.request_id)
                    break
        with self._lock:
            self.lost += 1
        partial = np.asarray(last_err.partial if last_err else [], np.int32)
        return RequestResult(
            req.request_id, partial, time.monotonic() * 1e3,
            last_err.replica if last_err else "-", req.created_ms,
            attempts=attempts, failed_over=False, outcome="lost",
            priority=req.priority,
            error=str(last_err) if last_err else "no attempt succeeded")

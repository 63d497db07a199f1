"""The paper's task-latency model:

    T_task(x, e) = T_trans(x, e) + T_que(x, e) + T_process(x, e) + T_re(x, es)

Given a task, a device profile and the device's *currently known* state
(possibly stale — by design), predict end-to-end latency.  Every scheduling
policy routes through this single predictor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.profile import AppProfile, DeviceProfile


@dataclass(frozen=True)
class Task:
    """One schedulable unit (paper: an image; fleet port: a request/step)."""

    task_id: int
    app_id: str
    size_kb: float                 # input size (image KB / prompt tokens)
    created_ms: float              # arrival time
    constraint_ms: float           # deadline (end-to-end)
    result_kb: float = 1.0         # result return size
    source: str = ""               # node where the task originated


@dataclass
class NodeState:
    """Dynamic state as known to a scheduler (may be stale)."""

    running: int = 0               # tasks currently executing in warm slots
    queued: int = 0                # tasks waiting for a slot
    reserved: int = 0              # slots held but not yet running (a
                                   # serving replica's mid-prefill lanes):
                                   # capacity-wise they are taken, queue-wise
                                   # they still owe interleave work
    cpu_load: float = 0.0          # background load [0, 1]
    updated_ms: float = 0.0        # telemetry timestamp
    brownout: bool = False         # node is degrading service under overload


def predict_process_ms(profile: DeviceProfile, task: Task,
                       state: NodeState, extra: int = 1) -> float:
    """T_process if the task were added now: concurrency = running + extra.

    Profiles in lane-occupancy mode (batched serving replicas) charge the
    joining task its prefill plus ``tokens_per_task`` decode steps at the
    *measured* step cadence for the post-join occupancy — the marginal cost
    of sharing the batch — instead of a full process-per-slot contended
    runtime (``AppProfile.process_time`` branches on ``lane_mode``)."""
    app = profile.app(task.app_id)
    conc = min(state.running + state.reserved + extra, profile.slots)
    return app.process_time(task.size_kb, conc, state.cpu_load)


def predict_queue_ms(profile: DeviceProfile, task: Task,
                     state: NodeState) -> float:
    """T_que: queued tasks drain through ``slots`` lanes at the contended
    per-task rate.  The paper's predictor uses exactly this queue-depth x
    profiled-time estimate (and flags its staleness risk).

    Lane-occupancy mode: a queued request waits for a lane to retire, i.e.
    one task's worth of decode steps at full occupancy, plus the chunked
    prefill interleave each queued prompt imposes on the loop — charged
    at the profile's measured per-token chunk rate
    (``AppProfile.interleave_ms``), the same rate the engine's SLO
    budget spends against, so predictor and budget stay one model (the
    incoming task's size stands in for the unknown queued-prompt
    sizes)."""
    if state.queued <= 0 and state.reserved <= 0:
        return 0.0
    app = profile.app(task.app_id)
    waves = state.queued / max(profile.slots, 1)
    if getattr(app, "lane_mode", False):
        per_task = app.tokens_per_task * app.step_curve(float(profile.slots))
        if state.cpu_load > 0.0 and app.load_curve is not None:
            per_task *= app.load_curve(state.cpu_load) / app.load_curve(0.0)
        # reserved (mid-prefill) lanes are not waiting for a slot, but
        # their remaining prefill chunks still interleave ahead of a
        # joining prompt's — charge them the interleave term only.  On a
        # paged replica a measured fraction of prompts joins on cached
        # prefix pages and skips (most of) that prefill: charging full
        # interleave would make shared-prompt replicas look busier than
        # they are, so the term is discounted by the observed hit rate.
        hit = min(max(getattr(app, "prefix_hit_rate", 0.0), 0.0), 1.0)
        return (waves * per_task
                + (state.queued + state.reserved) * (1.0 - hit)
                * app.interleave_ms(max(task.size_kb, 1.0)))
    per_task = app.process_time(task.size_kb, min(profile.slots, max(
        state.running, 1)), state.cpu_load)
    return waves * per_task


def predict_total_ms(profile: DeviceProfile, task: Task, state: NodeState,
                     remote: bool) -> float:
    """Full T_task.  ``remote``: include transfer + result-return terms."""
    t = 0.0
    if remote:
        t += profile.link.transfer_time(task.size_kb)          # T_trans
    t += predict_queue_ms(profile, task, state)                # T_que
    t += predict_process_ms(profile, task, state)              # T_process
    if remote:
        t += profile.link.transfer_time(task.result_kb)        # T_re
    return t


def slack_ms(task: Task, now_ms: float) -> float:
    """Remaining budget against the deadline."""
    return task.constraint_ms - (now_ms - task.created_ms)

"""The port's overload control against the JAX package's: feasibility
admission, bounded EDF queues with priority-aware eviction, the
deadline-aware shed sweep, brownout hysteresis and per-replica circuit
breakers on the port's engine (granite-8b smoke, f32), and the port's
simulator's overload accounting.  The controllers and the simulator are
copies of the JAX modules, so the same inputs must give the same traces
and the same records; the engine paths are the JAX tests run on the port.

The acceptance soak (``test_submit_never_blocks_at_3x_load``) drives a
fleet at ~3x capacity: every submit returns promptly with a classified
outcome (ok / rejected / shed / lost) and the fleet's counters close the
books exactly.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core.policies import make_policy as jmake_policy
from repro.serving import overload as jover
from repro_torch.configs import get_smoke_config
from repro_torch.core.latency import NodeState
from repro_torch.core.policies import make_policy
from repro_torch.core.profile import paper_raspberry_pi
from repro_torch.core.simulator import ChurnEvent, SimConfig, run_sim
from repro_torch.core.telemetry import MaintainProfileTable
from repro_torch.ft.monitor import FleetMonitor
from repro_torch.models import model as M
from repro_torch.serving import overload as tover
from repro_torch.serving.engine import (Replica, ReplicaSaturated, Request,
                                        ServingFleet, profile_replica)
from repro_torch.serving.overload import (BrownoutConfig, BrownoutController,
                                          CircuitBreaker, priority_rank)


@pytest.fixture(scope="module")
def model_setup():
    torch.set_num_threads(2)
    cfg = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    params = M.init_model(cfg, 0, "cpu")
    return cfg, params


def _prompt(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, size=(n,)).astype(np.int32)


def _wait_until(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _same_sim(port_res, jax_cfg_kw, policy):
    """The JAX simulator on the same config gives the same records."""
    jres = jsim.run_sim(jmake_policy(policy), jsim.SimConfig(**jax_cfg_kw))
    assert ([dataclasses.asdict(r) for r in port_res.records]
            == [dataclasses.asdict(r) for r in jres.records])


# ------------------------------------------------------------- unit: pieces
def test_priority_rank_orders_classes_and_tolerates_unknown():
    assert priority_rank("interactive") < priority_rank("batch")
    # a malformed client deprioritizes itself; it must never crash routing
    assert priority_rank("banana") > priority_rank("batch")
    for cls in ("interactive", "batch", "banana"):
        assert priority_rank(cls) == jover.priority_rank(cls)


def _brownout_trace(mod, kw, samples):
    bc = mod.BrownoutController(mod.BrownoutConfig(**kw))
    trace = []
    for ms, q in samples:
        bc.observe(ms, q)
        trace.append((bc.engaged, bc.transitions, bc.ewma_ms))
    return trace


def test_brownout_engages_and_restores_with_hysteresis():
    kw = dict(step_slo_ms=10.0, queue_high=100, queue_low=1, engage_after=3,
              restore_after=4, restore_ratio=0.7, alpha=0.5)
    cfg = BrownoutConfig(**kw)
    bc = BrownoutController(cfg)
    for _ in range(2):                  # under the dwell: not yet
        bc.observe(40.0, 0)
    assert not bc.engaged
    bc.observe(40.0, 0)                 # third consecutive over-sample
    assert bc.engaged and bc.transitions == 1
    # sustained calm restores, but only after ewma decays below the
    # restore band AND restore_after consecutive clear samples accrue
    for _ in range(50):
        bc.observe(0.0, 0)
        if not bc.engaged:
            break
    assert not bc.engaged and bc.transitions == 2
    assert bc.ewma_ms <= cfg.restore_ratio * cfg.step_slo_ms
    # the JAX controller walks the same states on the same samples
    samples = [(40.0, 0)] * 3 + [(0.0, 0)] * 20 + [(12.0, 0)] * 5
    assert (_brownout_trace(tover, kw, samples)
            == _brownout_trace(jover, kw, samples))


def test_brownout_band_samples_prevent_flapping():
    """A replica hovering AT the threshold must not flap: samples in the
    hysteresis band (neither over-pressure nor clear) reset both dwell
    counters, so intermittent pressure never engages."""
    cfg = BrownoutConfig(step_slo_ms=0.0, queue_high=4, queue_low=1,
                         engage_after=3, restore_after=3)
    bc = BrownoutController(cfg)
    for _ in range(30):                 # pressure never sustained 3-in-a-row
        bc.observe(0.0, 4)              # over
        bc.observe(0.0, 4)              # over
        bc.observe(0.0, 2)              # band: resets the dwell
    assert not bc.engaged and bc.transitions == 0
    # the same total pressure, sustained, engages immediately
    for _ in range(3):
        bc.observe(0.0, 4)
    assert bc.engaged and bc.transitions == 1


def test_circuit_breaker_full_transition_cycle():
    brk = CircuitBreaker(failure_threshold=2, open_ms=100.0)
    assert brk.acquire(now_ms=0.0)      # closed: traffic flows
    brk.on_failure(now_ms=1.0)
    assert brk.state == brk.CLOSED      # one failure: still closed
    brk.on_failure(now_ms=2.0)
    assert brk.state == brk.OPEN and brk.opens == 1
    assert not brk.available(now_ms=50.0)       # cooldown: no traffic
    assert not brk.acquire(now_ms=50.0)
    # cooldown elapsed: exactly ONE half-open probe slot
    assert brk.available(now_ms=103.0)
    assert brk.acquire(now_ms=103.0)
    assert brk.state == brk.HALF_OPEN
    assert not brk.acquire(now_ms=104.0)        # second caller loses the race
    brk.on_failure(now_ms=105.0)                # probe failed: re-open
    assert brk.state == brk.OPEN and brk.opens == 2
    assert not brk.acquire(now_ms=150.0)
    assert brk.acquire(now_ms=250.0)            # next probe
    brk.on_success()                            # probe healed the breaker
    assert brk.state == brk.CLOSED and brk.failures == 0
    assert brk.acquire(now_ms=251.0)


def test_circuit_breaker_rejects_zero_threshold():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        jover.CircuitBreaker(failure_threshold=0)


# ----------------------------------------------- telemetry: brownout export
def test_degraded_nodes_surface_through_heartbeat_table():
    table = MaintainProfileTable(staleness_alarm_ms=100.0)
    table.update("n0", NodeState(brownout=True), paper_raspberry_pi("n0"))
    table.update("n1", NodeState(), paper_raspberry_pi("n1"))
    assert table.degraded_nodes() == ["n0"]
    mon = FleetMonitor(table, on_dead=lambda n, r: None, poll_ms=20.0)
    assert mon.degraded_nodes() == ["n0"]       # operator view delegates


# ---------------------------------------------- routing: free-slot account
def test_view_free_slots_exclude_queued_jobs(model_setup):
    """Queued jobs hold no lane: only running and reserved (mid-prefill)
    lanes consume capacity."""
    cfg, params = model_setup
    rep = Replica("v0", cfg, params, slots=4, capacity=64)
    try:
        fleet = ServingFleet(make_policy("DDS"), source="v0",
                             coordinator="v0", monitor=False)
        fleet.add_replica(rep, profile=profile_replica(
            rep, prompt_lens=(8,), new_tokens=4))
        fleet.table.update("v0", NodeState(running=1, reserved=1, queued=3),
                           fleet.profiles["v0"])
        view = fleet._view("v0", rep)
        assert view.free_slots == 2     # 4 - 1 running - 1 reserved
        fleet.stop()
    finally:
        rep.stop(raise_on_leak=False)


# -------------------------------------------------- replica: bounded queue
def test_full_queue_sheds_lowest_priority_first(model_setup):
    """EDF bounded queue: when the queue is full, the WORST-ordered job
    goes: a batch arrival outranked by the tail is shed itself, and an
    interactive arrival evicts the worst queued batch job instead."""
    cfg, params = model_setup
    rep = Replica("q0", cfg, params, slots=1, capacity=512, max_queue=2)
    rep.profile = profile_replica(rep, prompt_lens=(8,), new_tokens=4)
    outcomes = {}

    def run(tag, req):
        try:
            outcomes[tag] = rep.generate_ex(req)
        except Exception as e:          # noqa: BLE001 — recorded, asserted
            outcomes[tag] = e

    threads = []

    def spawn(tag, req):
        t = threading.Thread(target=run, args=(tag, req))
        t.start()
        threads.append(t)

    try:
        # occupy the single lane with a long decode, then fill the queue
        spawn("long", Request(0, _prompt(cfg), 96, 1e9))
        _wait_until(lambda: rep.state().running + rep.state().reserved >= 1,
                    what="lane occupied")
        spawn("batch1", Request(1, _prompt(cfg), 4, 1e9, priority="batch"))
        spawn("inter1", Request(2, _prompt(cfg), 4, 1e9))
        _wait_until(lambda: rep.state().queued == 2, what="queue full")

        # a batch arrival ranks below the queued tail: it is shed itself,
        # with the profile-derived retry-after hint attached
        with pytest.raises(ReplicaSaturated) as ei:
            rep.generate_ex(Request(3, _prompt(cfg), 4, 1e9,
                                    priority="batch"))
        assert ei.value.retry_after_ms > 0.0
        assert rep.state().queued == 2  # nothing queued was touched

        # an interactive arrival outranks the queued batch job: the batch
        # job is evicted (explicit ReplicaSaturated), the arrival queues
        spawn("inter2", Request(4, _prompt(cfg), 4, 1e9))
        _wait_until(lambda: isinstance(outcomes.get("batch1"),
                                       ReplicaSaturated),
                    what="batch job evicted")
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads), "a submit hung"
        # everyone else completed normally, in spite of the churn
        for tag in ("long", "inter1", "inter2"):
            toks, _, _ = outcomes[tag]
            assert len(toks) > 0, tag
    finally:
        for t in threads:
            t.join(timeout=5.0)
        rep.stop(raise_on_leak=False)


def test_shed_sweep_drops_queued_jobs_past_their_slack(model_setup):
    """Deadline-aware shedding: a queued job whose predicted queue+process
    time exceeds its remaining slack is shed by the decode loop's sweep,
    explicitly and with a retry-after hint, instead of being served late."""
    cfg, params = model_setup
    rep = Replica("s0", cfg, params, slots=1, capacity=512)
    rep.profile = profile_replica(rep, prompt_lens=(8,), new_tokens=4)
    got = {}

    def run():
        try:
            got["r"] = rep.generate_ex(Request(1, _prompt(cfg), 4, 150.0))
        except Exception as e:          # noqa: BLE001
            got["r"] = e

    try:
        long_t = threading.Thread(
            target=lambda: rep.generate(Request(0, _prompt(cfg), 256, 1e9)))
        long_t.start()
        _wait_until(lambda: rep.state().running + rep.state().reserved >= 1,
                    what="lane occupied")
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60.0)
        assert not t.is_alive(), "queued request hung instead of shedding"
        assert isinstance(got["r"], ReplicaSaturated), got["r"]
        assert "shed" in str(got["r"])
        assert got["r"].retry_after_ms > 0.0
        long_t.join(timeout=60.0)
    finally:
        rep.stop(raise_on_leak=False)


# ------------------------------------------------------- fleet: admission
def test_admission_rejects_infeasible_deadline(model_setup):
    cfg, params = model_setup
    rep = Replica("a0", cfg, params, slots=2, capacity=64)
    fleet = ServingFleet(make_policy("DDS"), source="a0", coordinator="a0",
                         monitor=False, admission_margin=1.0)
    fleet.add_replica(rep, profile=profile_replica(
        rep, prompt_lens=(8,), new_tokens=4))
    try:
        r = fleet.submit(Request(0, _prompt(cfg), 4, 0.25))
        assert r.outcome == "rejected" and not r.ok
        assert r.attempts == 0          # rejected BEFORE any placement
        assert "feasibility floor" in r.error
        assert fleet.rejected == 1 and fleet.lost == 0
        ok = fleet.submit(Request(1, _prompt(cfg), 4, 1e9))
        assert ok.outcome == "ok" and len(ok.tokens) == 4
        assert ok.ttft_ms > 0.0
    finally:
        fleet.stop()


def test_brownout_clamps_decode_budget_and_reports_degraded(model_setup):
    """While engaged, admissions are clamped to the configured decode-token
    cap and the result carries ``degraded``: reversible service
    degradation, visible to the client and the heartbeat."""
    cfg, params = model_setup
    rep = Replica("b0", cfg, params, slots=2, capacity=64,
                  brownout=BrownoutConfig(queue_high=1, queue_low=0,
                                          engage_after=1, restore_after=10**6,
                                          max_new_tokens_cap=2))
    try:
        rep.brownout.observe(0.0, 5)    # force-engage via queue pressure
        assert rep.browned_out
        assert rep.state().brownout     # exported to the UP heartbeat
        toks, _, degraded = rep.generate_ex(Request(0, _prompt(cfg), 16, 1e9))
        assert degraded and len(toks) == 2
        # brownout also shrinks the prefill budget ceiling
        assert rep.budget_tokens(0) <= max(
            int(rep.prefill_chunk_tokens
                * rep.brownout.cfg.budget_factor), 1)
    finally:
        rep.stop(raise_on_leak=False)


# ------------------------------------------------------ fleet: 3x-load soak
def test_submit_never_blocks_at_3x_load(model_setup):
    """The acceptance soak: open-loop arrivals at ~3x what one small
    replica can serve.  Every submit returns a classified outcome, the
    counters close the books exactly, and nothing blocks past the bound."""
    cfg, params = model_setup
    rep = Replica("o0", cfg, params, slots=2, capacity=64, max_queue=4)
    fleet = ServingFleet(make_policy("DDS"), source="o0", coordinator="o0",
                         monitor=False, admission_margin=1.0)
    fleet.add_replica(rep, profile=profile_replica(
        rep, prompt_lens=(8,), new_tokens=4))
    n, new_tokens = 24, 8
    # measure one warm request, then offer ~3x the implied service rate
    t0 = time.perf_counter()
    fleet.submit(Request(990, _prompt(cfg), new_tokens, 1e9))
    measured_s = time.perf_counter() - t0
    interval_s = measured_s / rep.slots / 3.0
    deadline_ms = 4.0 * measured_s * 1e3
    results = [None] * n
    threads = []
    try:
        for i in range(n):
            req = Request(i, _prompt(cfg, seed=i), new_tokens, deadline_ms,
                          priority="batch" if i % 3 == 2 else "interactive")
            t = threading.Thread(
                target=lambda i=i, req=req:
                    results.__setitem__(i, fleet.submit(req)))
            t.start()
            threads.append(t)
            time.sleep(interval_s)
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads), \
            "a submit hung under overload: silent loss"
        assert all(r is not None for r in results)
        counts = {"ok": 0, "rejected": 0, "shed": 0, "lost": 0}
        for r in results:
            counts[r.outcome] += 1      # KeyError = unclassified outcome
            assert r.ok == (r.outcome == "ok")
            if not r.ok:
                assert r.error          # failure is explicit, never silent
        assert sum(counts.values()) == n
        assert fleet.shed == counts["shed"]
        assert fleet.rejected == counts["rejected"]
        assert fleet.lost == counts["lost"]
        assert counts["ok"] >= 1        # overload control served SOMEONE
    finally:
        for t in threads:
            t.join(timeout=5.0)
        fleet.stop()


# ------------------------------------------------------------- simulator
def test_simulator_overload_accounting_closes():
    kw = dict(num_tasks=240, interval_ms=10.0, constraint_ms=600.0,
              admission_margin=1.1, max_queue=4)
    res = run_sim(make_policy("DDS_EDF"), SimConfig(**kw))
    assert res.num_shed > 0             # 3x-ish load: the queues DID bound
    for rec in res.records:             # every task accounted, none silent
        assert (rec.finished_ms < float("inf") or rec.lost or rec.dropped
                or rec.rejected or rec.shed), rec
    assert res.num_admitted == len(res.records) - res.num_rejected
    # hit rate reads scheduling quality over the admitted, feasible work
    denom = max(res.num_admitted - res.num_infeasible, 1)
    assert res.hit_rate == pytest.approx(res.num_met / denom)
    _same_sim(res, kw, "DDS_EDF")


def test_simulator_overload_defaults_off():
    """admission_margin=0 / max_queue=0 (the defaults) reproduce the
    pre-overload behavior exactly: nothing rejected, nothing shed."""
    kw = dict(num_tasks=60, interval_ms=20.0, constraint_ms=1000.0)
    res = run_sim(make_policy("DDS"), SimConfig(**kw))
    assert res.num_rejected == 0 and res.num_shed == 0
    _same_sim(res, kw, "DDS")


def test_simulator_churn_infeasible_excluded_from_hit_rate():
    res = run_sim(make_policy("DDS"), SimConfig(
        num_tasks=150, interval_ms=20.0, constraint_ms=400.0,
        churn=(ChurnEvent(300, "kill", "edge_server"),
               ChurnEvent(2000, "rejoin", "edge_server"))))
    # a kill with a tight constraint strands some tasks with zero slack
    # after the detection window: lost AND infeasible (physics, not
    # scheduling), and the hit rate's denominator excludes them
    assert 0 <= res.num_infeasible <= res.num_lost
    denom = max(res.num_admitted - res.num_infeasible, 1)
    assert res.hit_rate == pytest.approx(res.num_met / denom)
    assert res.hit_rate >= res.num_met / len(res.records)
    _same_sim(res, dict(
        num_tasks=150, interval_ms=20.0, constraint_ms=400.0,
        churn=(jsim.ChurnEvent(300, "kill", "edge_server"),
               jsim.ChurnEvent(2000, "rejoin", "edge_server"))), "DDS")

"""The port's fault injection and failover (``repro_torch.ft.faults``, the
serving fleet's failure path, churn in the port's simulator): the chaos
tests of the JAX package run on the port's engine, granite-8b smoke in
f32, weights bridged from the JAX model.

The acceptance test (``test_kill_mid_decode_fails_over_token_identical``)
kills a replica mid-decode: every in-flight request either completes
token-identical to an undisturbed run, the port's ``generate_sequential``
and the JAX replica's alike, or is reported failed with its attempts
counted.  Two tests go beyond the JAX package's: ``slow(f)`` stretches a
paged decode step (the JAX injector does not wrap the paged step
executables), and a seeded sampled request that failed over equals its
undisturbed stream.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.latency import NodeState
from repro_torch.core.policies import FORWARD, Policy, make_policy
from repro_torch.core.profile import paper_raspberry_pi
from repro_torch.core.simulator import ChurnEvent, SimConfig, run_sim
from repro_torch.core.telemetry import MaintainProfileTable
from repro_torch.ft import faults
from repro_torch.ft.monitor import FleetMonitor
from repro_torch.serving.engine import (Replica, ReplicaLeak, Request,
                                        ServingFleet, profile_replica)


class PinPolicy(Policy):
    """Test policy: place every request on ``target`` while it is a live
    peer; fall back to the coordinator itself once it is gone (exactly the
    information a real policy would have after eviction)."""

    name = "PIN"

    def __init__(self, target: str):
        self.target = target

    def decide_source(self, task, now, local):
        return FORWARD

    def decide_coordinator(self, task, now, coord, peers):
        if self.target in peers:
            return self.target
        return coord.profile.device_id


@pytest.fixture(scope="module")
def model_setup():
    """granite-8b smoke in f32: the port's config and model, and the JAX
    config and weights they were bridged from."""
    torch.set_num_threads(2)
    jc = jget_smoke("granite-8b").replace(param_dtype=jnp.float32,
                                          dtype=jnp.float32)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    cfg = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    return cfg, params, jc, jp


# --------------------------------------------------------- cheap unit tests
def test_fault_plan_validation():
    with pytest.raises(ValueError):
        faults.FaultEvent(0.0, "meteor")
    with pytest.raises(ValueError):
        faults.slow(0.0, factor=0.5)        # a speedup is not a fault
    plan = faults.FaultPlan([faults.heal(50.0), faults.crash(10.0)])
    assert [e.kind for e in plan.events] == ["crash", "heal"]  # time-sorted


def test_staleness_alarm_derived_from_heartbeat():
    """The MP staleness alarm is a multiple of the configured heartbeat,
    not the 1000 ms training default."""
    fleet = ServingFleet(make_policy("DDS"), "a", "a", heartbeat_ms=10.0,
                         staleness_factor=5.0, monitor=False)
    assert fleet.table.staleness_alarm_ms == pytest.approx(50.0)
    assert fleet.staleness_alarm_ms >= 2 * fleet.heartbeat_ms
    with pytest.raises(ValueError):
        # one missed heartbeat must never mean death
        ServingFleet(make_policy("DDS"), "a", "a", heartbeat_ms=10.0,
                     staleness_factor=1.5, monitor=False)


def _table_with(name: str) -> MaintainProfileTable:
    table = MaintainProfileTable(staleness_alarm_ms=100.0)
    table.update(name, NodeState(), paper_raspberry_pi(name))
    return table


def test_fleet_monitor_declares_once_then_revives():
    table = _table_with("n0")
    deaths = []
    mon = FleetMonitor(table, on_dead=lambda n, r: deaths.append((n, r)),
                       poll_ms=20.0)
    t0 = time.monotonic() * 1e3
    # on-time sweeps: the node goes stale between them -> one declaration
    assert mon.check_once(t0) == []
    for k in range(1, 9):
        mon.check_once(t0 + 20.0 * k)
    assert [n for n, _ in deaths] == ["n0"]
    assert "staleness" in deaths[0][1]
    # declared once: further sweeps stay quiet until a revive re-arms
    assert mon.check_once(t0 + 200.0) == []
    mon.revive("n0")
    assert mon.check_once(t0 + 220.0) == ["n0"]


def test_fleet_monitor_abstains_after_starved_sweep():
    """A sweep arriving far later than scheduled means the process (not
    the fleet) stalled: no deaths are declared off its receipt clocks.
    The next on-time sweep still catches a real death."""
    table = _table_with("n0")
    deaths = []
    mon = FleetMonitor(table, on_dead=lambda n, r: deaths.append(n),
                       poll_ms=20.0)
    t0 = time.monotonic() * 1e3
    mon.check_once(t0)
    assert mon.check_once(t0 + 2000.0) == []    # starved sweep: abstain
    assert deaths == []
    assert mon.check_once(t0 + 2020.0) == ["n0"]  # clean interval: declare


def test_fleet_monitor_progress_signal():
    """stalled_fn feeds hang detection: stale-free nodes can still die."""
    table = _table_with("n0")       # heartbeat is FRESH throughout
    deaths = []
    mon = FleetMonitor(table, on_dead=lambda n, r: deaths.append((n, r)),
                       poll_ms=20.0, stalled_fn=lambda: ["n0"])
    mon.check_once(time.monotonic() * 1e3)
    assert deaths and deaths[0][0] == "n0" and "stalled" in deaths[0][1]


# ------------------------------------------------------------ simulator churn
# The JAX package's churn properties, on the port's simulator.  The same
# kinds of plan (kill and rejoin, partition and heal, a kill with no retry
# left, churn on the source) are held record for record against the JAX
# simulator in tests/test_torch_scheduler.py.
def _accounted(res):
    return all(r.finished_ms < float("inf") or r.lost or r.dropped
               for r in res.records)


def test_sim_kill_triggers_failover_and_accounts_everything():
    cfg = SimConfig(num_tasks=100, interval_ms=30, constraint_ms=3000,
                    churn=(ChurnEvent(500, "kill", "rasp2"),))
    res = run_sim(make_policy("DDS"), cfg)
    assert res.num_failed_over > 0          # in-flight work was re-placed
    assert _accounted(res)
    base = run_sim(make_policy("DDS"), SimConfig(
        num_tasks=100, interval_ms=30, constraint_ms=3000))
    assert res.num_met <= base.num_met      # churn cannot help


def test_sim_kill_rejoin_stale_incarnation_guard():
    """A fast kill+rejoin must not let the dead incarnation's in-flight
    finish events complete tasks (or corrupt slot accounting)."""
    cfg = SimConfig(num_tasks=100, interval_ms=30, constraint_ms=3000,
                    churn=(ChurnEvent(500, "kill", "rasp2"),
                           ChurnEvent(560, "rejoin", "rasp2")))
    res = run_sim(make_policy("DDS"), cfg)
    assert _accounted(res)
    # the rejoined node serves traffic again
    assert any(r.node == "rasp2" and r.finished_ms < float("inf")
               and r.task.created_ms > 560 for r in res.records)


def test_sim_partition_loses_results_until_heal():
    cfg = SimConfig(num_tasks=100, interval_ms=30, constraint_ms=3000,
                    churn=(ChurnEvent(500, "partition", "edge_server"),
                           ChurnEvent(1500, "heal", "edge_server")))
    res = run_sim(make_policy("DDS"), cfg)
    assert _accounted(res)
    assert res.num_failed_over > 0          # unreachable results re-ran


def test_sim_retries_are_bounded_and_losses_visible():
    cfg = SimConfig(num_tasks=60, interval_ms=20, constraint_ms=1500,
                    retry_max=1,            # first placement is the only one
                    churn=(ChurnEvent(300, "kill", "edge_server"),))
    res = run_sim(make_policy("AOE"), cfg)  # AOE: everything on the victim
    assert res.num_lost > 0                 # no retries left -> visible loss
    assert all(r.attempts <= cfg.retry_max for r in res.records)
    assert _accounted(res)


def test_sim_churn_on_source_rejected():
    cfg = SimConfig(num_tasks=10, churn=(ChurnEvent(100, "kill", "rasp1"),))
    with pytest.raises(ValueError):
        run_sim(make_policy("DDS"), cfg)


# --------------------------------------------------------- live fault chaos
def _wait_for_lane(rep, timeout_s=30.0):
    """Block until ``rep`` has an active decode lane (a request in flight)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(j is not None for j in rep._lanes):
            return
        time.sleep(0.002)
    raise AssertionError(f"no request ever started decoding on {rep.name}")


def _submit_all(fleet, reqs):
    results = [None] * len(reqs)

    def run(i):
        results[i] = fleet.submit(reqs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    return results, threads


def _pinned_fleet(rep0, rep1, target):
    fleet = ServingFleet(PinPolicy(target), source=rep0.name,
                         coordinator=rep0.name, heartbeat_ms=20.0,
                         staleness_factor=5.0,        # 100 ms alarm
                         progress_timeout_ms=2000.0, max_attempts=3,
                         retry_backoff_ms=5.0)
    fleet.add_replica(rep0)
    fleet.add_replica(rep1)
    return fleet


def test_kill_mid_decode_fails_over_token_identical(model_setup):
    """ACCEPTANCE: crash a replica mid-decode.  Every in-flight request
    either completes token-identical to an undisturbed run (failover
    re-decodes from scratch on the survivor) or is reported failed with
    its attempts counted: zero silent losses.  The undisturbed streams are
    the port's batch-1 ``generate_sequential`` and the JAX replica's."""
    cfg, params, jc, jp = model_setup
    rep0 = Replica("serve0", cfg, params, slots=2, capacity=64)
    rep1 = Replica("serve1", cfg, params, slots=2, capacity=64)
    new_tokens = 48
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=(8,)).astype(np.int32)
               for _ in range(4)]
    expected = [rep0.generate_sequential(
        Request(100 + i, p, new_tokens, 1e9)).tolist()
        for i, p in enumerate(prompts)]
    jrep = jeng.Replica("jax", jc, jp, slots=1, capacity=64,
                        prefill_chunk_tokens=1)
    try:
        assert expected == [jrep.generate_sequential(
            jeng.Request(100 + i, p, new_tokens, 1e9)).tolist()
            for i, p in enumerate(prompts)]
    finally:
        jrep.stop()

    fleet = _pinned_fleet(rep0, rep1, "serve1")
    inj = faults.inject(fleet, "serve1")
    reqs = [Request(i, p, new_tokens, 1e9) for i, p in enumerate(prompts)]
    results, threads = _submit_all(fleet, reqs)
    # kill serve1 once it is actually decoding: a fixed sleep races a
    # fast replica that can finish the whole burst first
    _wait_for_lane(rep1)
    inj.apply("crash")
    for t in threads:
        t.join(timeout=600.0)
    assert not any(t.is_alive() for t in threads), "submit hung: silent loss"

    assert "serve1" in fleet.dead   # the monitor evicted the crashed replica
    n_failed_over = 0
    for i, r in enumerate(results):
        assert r is not None
        if r.ok:
            assert r.tokens.tolist() == expected[i], \
                f"request {i}: failover stream diverged"
            n_failed_over += int(r.failed_over or r.attempts > 1)
        else:
            assert r.attempts > 1   # failure is explicit and counted
    # the crash landed mid-burst: something must actually have failed over
    assert n_failed_over + sum(1 for r in results if not r.ok) > 0
    assert fleet.lost == sum(1 for r in results if not r.ok)
    inj.stop()
    fleet.stop()


def test_sampled_failover_equals_undisturbed_stream(model_setup):
    """A seeded sampled request whose replica crashes mid-decode comes back
    from the survivor with the stream it gets undisturbed: its draws key
    on (seed, token count), so a retry from scratch redraws the same
    tokens."""
    cfg, params, _, _ = model_setup
    rep0 = Replica("samp0", cfg, params, slots=2, capacity=128)
    rep1 = Replica("samp1", cfg, params, slots=2, capacity=128)
    prompt = np.random.default_rng(9).integers(
        2, cfg.vocab_size, size=(8,)).astype(np.int32)

    def sampled(rid):
        return Request(rid, prompt, 100, 1e9, temperature=0.9, top_p=0.95,
                       seed=42)

    undisturbed = rep0.generate(sampled(0)).tolist()
    assert len(set(undisturbed)) > 1            # actually sampling
    fleet = _pinned_fleet(rep0, rep1, "samp1")
    inj = faults.inject(fleet, "samp1")
    results, threads = _submit_all(fleet, [sampled(1)])
    _wait_for_lane(rep1)
    inj.apply("crash")
    threads[0].join(timeout=600.0)
    assert not threads[0].is_alive(), "submit hung: silent loss"
    r = results[0]
    assert r.ok and r.attempts > 1 and r.replica == "samp0", r
    assert r.tokens.tolist() == undisturbed
    assert fleet.dead == ["samp1"] and fleet.lost == 0
    inj.stop()
    fleet.stop()


def test_hang_detected_by_progress_watchdog(model_setup):
    """A hung executable keeps heartbeating, so staleness never fires; the
    decode-progress watchdog must evict it and unblock the caller."""
    cfg, params, _, _ = model_setup
    rep = Replica("hang0", cfg, params, slots=2, capacity=128)
    fleet = ServingFleet(make_policy("DDS"), source="hang0",
                         coordinator="hang0", heartbeat_ms=20.0,
                         staleness_factor=10.0, progress_timeout_ms=300.0,
                         max_attempts=2, retry_backoff_ms=5.0)
    fleet.add_replica(rep)
    inj = faults.inject(fleet, "hang0")

    reqs = [Request(0, np.arange(2, 10, dtype=np.int32), 100, 1e9)]
    results, threads = _submit_all(fleet, reqs)
    _wait_for_lane(rep)             # hang mid-decode, not a parked replica
    inj.apply("hang")
    threads[0].join(timeout=120.0)
    assert not threads[0].is_alive(), "caller stayed blocked on a hung replica"
    r = results[0]
    assert r is not None and not r.ok and r.error
    assert "hang0" in fleet.dead
    assert fleet.lost == 1          # visible, accounted
    inj.apply("heal")               # let the decode thread exit cleanly
    inj.stop()
    fleet.stop()


def test_partition_evicted_by_staleness(model_setup):
    """Suppressed heartbeats alone (node healthy, network gone) must trip
    the staleness alarm and evict the replica from routing."""
    cfg, params, _, _ = model_setup
    rep = Replica("part0", cfg, params, slots=2, capacity=64)
    fleet = ServingFleet(make_policy("DDS"), source="part0",
                         coordinator="part0", heartbeat_ms=20.0,
                         staleness_factor=5.0, max_attempts=2,
                         retry_backoff_ms=5.0)
    fleet.add_replica(rep)
    inj = faults.inject(fleet, "part0")
    inj.apply("partition")
    deadline = time.monotonic() + 10.0
    while "part0" not in fleet.dead and time.monotonic() < deadline:
        time.sleep(0.02)
    assert "part0" in fleet.dead
    assert "part0" not in fleet.replicas
    # with no live replica, a submit returns an explicit error, fast
    r = fleet.submit(Request(0, np.arange(2, 8, dtype=np.int32), 4, 1e9))
    assert not r.ok and "no live replicas" in r.error
    inj.stop()
    fleet.stop()


def test_graceful_drain_no_dropped_streams(model_setup):
    """Scale-in: remove_replica(drain=True) lets active lanes finish and
    migrates queued requests to the survivor: every stream completes."""
    cfg, params, _, _ = model_setup
    rep0 = Replica("drain0", cfg, params, slots=2, capacity=64)
    rep1 = Replica("drain1", cfg, params, slots=2, capacity=64)
    fleet = ServingFleet(PinPolicy("drain0"), source="drain1",
                         coordinator="drain1", heartbeat_ms=20.0,
                         max_attempts=3, retry_backoff_ms=5.0)
    fleet.add_replica(rep0)
    fleet.add_replica(rep1)

    new_tokens = 32
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=(8,)).astype(np.int32)
               for _ in range(4)]
    # 4 requests onto 2 slots: two decode, two queue behind them
    reqs = [Request(i, p, new_tokens, 1e9) for i, p in enumerate(prompts)]
    results, threads = _submit_all(fleet, reqs)
    time.sleep(0.3)
    fleet.remove_replica("drain0", drain=True)      # scale-in under load
    for t in threads:
        t.join(timeout=600.0)
    assert not any(t.is_alive() for t in threads)
    for i, r in enumerate(results):
        assert r is not None and r.ok, f"request {i} dropped on scale-in: {r}"
        assert len(r.tokens) == new_tokens
    assert fleet.lost == 0
    # queued requests really did migrate (unless all 4 finished pre-drain)
    assert fleet.stats.get("drain1", 0) + fleet.stats.get("drain0", 0) >= 4
    fleet.stop()


def test_replica_stop_surfaces_leaked_thread(model_setup):
    """stop() must not report success when the decode thread failed to
    exit."""
    cfg, params, _, _ = model_setup
    rep = Replica("leak0", cfg, params, slots=1, capacity=64)
    gate = threading.Event()
    hung = threading.Thread(target=gate.wait, daemon=True)
    hung.start()
    real = rep._thread
    rep._thread = hung              # simulate an unjoinable decode thread
    with pytest.raises(ReplicaLeak):
        rep.stop(timeout_s=0.1)
    assert rep.stop(timeout_s=0.1, raise_on_leak=False) is False
    gate.set()
    rep._thread = real
    assert rep.stop() is True       # the real thread exits cleanly


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_slow_fault_inflates_observed_step_time(model_setup, paged):
    """slow(f) is adaptation, not failure: the live step EWMA must absorb
    the inflated cadence (what shifts DDS routing away).  The port's step
    executables serve ring and paged lanes alike, so a paged decode step
    is stretched too.  Both sides are the live EWMA after the same
    request, un-slowed just before the fault and slowed after it, so a
    load spike on the host cannot inflate one of them alone."""
    cfg, params, _, _ = model_setup
    rep = Replica("slow0", cfg, params, slots=2, capacity=64, paged=paged,
                  page_size=8)
    prof = profile_replica(rep, prompt_lens=(8,), new_tokens=4)
    rep.profile = prof
    prompt = np.arange(2, 10, dtype=np.int32)
    rep.generate(Request(0, prompt, 24, 1e9))
    before = prof.step_curve(1.0)
    inj = faults.FaultInjector(rep, publisher=None)
    inj.apply("slow", factor=5.0)
    rep.generate(Request(1, prompt, 24, 1e9))
    after = prof.step_curve(1.0)
    assert after > before * 1.5, (before, after)
    inj.stop()
    rep.stop()

"""The port's copy of the paper's scheduler layer against the JAX
package's: the discrete-event simulator (``repro_torch.core.simulator``)
and the live ``Fleet`` of ``Worker``s over ``Link``s
(``core/scheduler.py``, ``core/node.py``, ``core/network.py``).

The simulator is deterministic given its config (``SimConfig.seed`` feeds
its loss draws), so both packages must produce the same ``TaskRecord``s
(placement, start, finish, attempts, lost, dropped, shed) for every policy,
under churn and under UDP loss.  The paper-figure assertions of the JAX
package's DDS tests and its live-fleet tests then run on the port.
"""
import dataclasses
import time

import pytest

from repro.core import policies as jpol
from repro.core import simulator as jsim
from repro_torch.core import Fleet, Worker, certify
from repro_torch.core.latency import Task
from repro_torch.core.network import Link
from repro_torch.core.policies import make_policy
from repro_torch.core.profile import (FACE, LinkProfile, paper_edge_server,
                                      paper_raspberry_pi)
from repro_torch.core.simulator import ChurnEvent, SimConfig, run_sim

POLICIES = ["AOR", "AOE", "EODS", "DDS", "DDS_EDF", "DDS_P2C", "JSQ"]


def _records(res):
    return [dataclasses.asdict(r) for r in res.records]


def _both(policy, **kw):
    """Run the port's and the JAX simulator on one config; ``churn`` is a
    tuple of (at_ms, kind, node) triples."""
    churn = kw.pop("churn", ())
    port = run_sim(make_policy(policy), SimConfig(
        churn=tuple(ChurnEvent(*c) for c in churn), **kw))
    ref = jsim.run_sim(jpol.make_policy(policy), jsim.SimConfig(
        churn=tuple(jsim.ChurnEvent(*c) for c in churn), **kw))
    return port, ref


# ---------------------------------------------- the simulator, record by record
@pytest.mark.parametrize("policy", POLICIES)
def test_sim_records_identical_to_jax(policy):
    """Loaded enough that queues form, placements split and deadlines are
    missed, with the background load on the coordinator."""
    port, ref = _both(policy, num_tasks=200, interval_ms=30.0,
                      constraint_ms=1500.0, edge_cpu_load=0.5)
    assert _records(port) == _records(ref)
    assert len(port.placement_counts()) > 1 or policy in ("AOR", "AOE")
    assert 0 < port.num_met < 200


CHURN_POLICIES = ["DDS", "DDS_EDF", "AOE"]


@pytest.mark.parametrize("policy", CHURN_POLICIES)
@pytest.mark.parametrize("churn,kw", [
    (((500, "kill", "rasp2"), (900, "rejoin", "rasp2")), {}),
    (((400, "kill", "edge_server"), (2000, "rejoin", "edge_server")), {}),
    (((500, "partition", "edge_server"), (1500, "heal", "edge_server")), {}),
    # the first placement is the only one: no retry is left after the kill
    (((300, "kill", "edge_server"),), {"retry_max": 1}),
], ids=["kill-rejoin-peer", "kill-rejoin-coordinator", "partition-heal",
        "kill-coordinator-no-retry"])
def test_sim_records_identical_to_jax_under_churn(policy, churn, kw):
    port, ref = _both(policy, num_tasks=120, interval_ms=25.0,
                      constraint_ms=2000.0, churn=churn, **kw)
    assert _records(port) == _records(ref)
    assert port.num_failed_over == ref.num_failed_over
    assert port.num_lost == ref.num_lost
    if kw and policy == "AOE":          # everything on the victim: losses
        assert port.num_lost > 0


@pytest.mark.parametrize("policy", CHURN_POLICIES)
@pytest.mark.parametrize("kind", ["kill", "partition"])
def test_sim_churn_on_source_rejected_by_both(policy, kind):
    """Churn on the source node is not modeled: both packages refuse the
    config with the same message."""
    churn = ((100, kind, "rasp1"),)
    with pytest.raises(ValueError) as port:
        _both(policy, num_tasks=10, churn=churn)
    with pytest.raises(ValueError) as ref:
        jsim.run_sim(jpol.make_policy(policy), jsim.SimConfig(
            num_tasks=10, churn=(jsim.ChurnEvent(*churn[0]),)))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("policy", ["AOE", "DDS", "EODS"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sim_records_identical_to_jax_with_udp_loss(policy, seed):
    # a dropped task never completes, so heartbeats run on to the
    # simulator's horizon: a 500 ms period keeps that short
    port, ref = _both(policy, num_tasks=80, interval_ms=40.0,
                      constraint_ms=2000.0, loss_prob=0.3, seed=seed,
                      heartbeat_ms=500.0)
    assert _records(port) == _records(ref)
    if policy == "AOE":                 # everything forwarded: some lost
        assert port.num_dropped > 0


# ------------------------------------------- the paper's figures, on the port
@pytest.fixture(scope="module")
def fig5_results():
    out = {}
    for policy in ["AOR", "AOE", "EODS", "DDS"]:
        for c in [100, 500, 1000, 2000, 5000]:
            port, ref = _both(policy, num_tasks=50, interval_ms=50,
                              constraint_ms=c, include_rasp2=False)
            assert port.num_met == ref.num_met
            out[policy, c] = port.num_met
    return out


def test_paper_min_constraint_floor(fig5_results):
    """No policy satisfies sub-200ms constraints (paper Fig 5 obs. 1)."""
    for p in ["AOR", "AOE", "EODS", "DDS"]:
        assert fig5_results[p, 100] == 0


def test_paper_edge_beats_device(fig5_results):
    """AOE >= AOR across constraints (paper obs. 2: powerful nodes win)."""
    for c in [500, 1000, 2000, 5000]:
        assert fig5_results["AOE", c] >= fig5_results["AOR", c]


def test_paper_distributed_beats_single_node(fig5_results):
    """EODS and DDS beat both single-node baselines in the constrained
    regime (paper obs. 4)."""
    for c in [1000, 2000]:
        single_best = max(fig5_results["AOR", c], fig5_results["AOE", c])
        assert fig5_results["EODS", c] >= single_best
        assert fig5_results["DDS", c] >= single_best - 1


def test_paper_more_met_with_looser_constraints(fig5_results):
    for p in ["AOR", "AOE", "EODS", "DDS"]:
        counts = [fig5_results[p, c] for c in [500, 1000, 2000, 5000]]
        assert counts == sorted(counts)


def test_paper_longer_interval_helps():
    """Fig 5a vs 5d: AOR@1000ms goes from near-zero to all-met as the
    interval stretches 50 -> 500ms."""
    tight = run_sim(make_policy("AOR"), SimConfig(
        num_tasks=50, interval_ms=50, constraint_ms=1000,
        include_rasp2=False)).num_met
    loose = run_sim(make_policy("AOR"), SimConfig(
        num_tasks=50, interval_ms=500, constraint_ms=1000,
        include_rasp2=False)).num_met
    assert tight <= 5 and loose == 50


def test_paper_fig8_extra_device_helps():
    """DDS + Rasp2 beats DDS alone under every coordinator load (Fig 8)."""
    for load in [0.0, 0.5, 1.0]:
        base = run_sim(make_policy("DDS"), SimConfig(
            num_tasks=300, interval_ms=50, constraint_ms=5000,
            include_rasp2=False, edge_cpu_load=load)).num_met
        ext = run_sim(make_policy("DDS"), SimConfig(
            num_tasks=300, interval_ms=50, constraint_ms=5000,
            include_rasp2=True, edge_cpu_load=load)).num_met
        assert ext > base * 1.2, (load, base, ext)


def test_paper_fig8_load_hurts():
    met = [run_sim(make_policy("DDS"), SimConfig(
        num_tasks=300, interval_ms=50, constraint_ms=5000,
        include_rasp2=True, edge_cpu_load=l)).num_met
        for l in [0.0, 0.5, 1.0]]
    assert met[0] >= met[1] >= met[2]
    assert met[2] < met[0]


def test_udp_loss_drops_tasks():
    cfg = SimConfig(num_tasks=50, interval_ms=50, constraint_ms=2000,
                    include_rasp2=False, loss_prob=0.5, seed=3)
    res = run_sim(make_policy("AOE"), cfg)
    dropped = sum(1 for r in res.records if r.dropped)
    assert 10 < dropped < 40            # ~50% of forwarded tasks lost
    assert res.num_met <= 50 - dropped


def test_beyond_dds_edf_sheds_late_work():
    """DDS_EDF should match or beat plain DDS when overloaded."""
    cfg = SimConfig(num_tasks=200, interval_ms=20, constraint_ms=3000)
    base = run_sim(make_policy("DDS"), cfg).num_met
    edf = run_sim(make_policy("DDS_EDF"), cfg).num_met
    assert edf >= base


def test_staleness_degrades_decisions():
    """Larger heartbeat periods (staler MP tables) should not improve DDS
    outcomes (generally degrade them)."""
    met = []
    for hb in [1.0, 500.0, 5000.0]:
        cfg = SimConfig(num_tasks=200, interval_ms=30, constraint_ms=3000,
                        heartbeat_ms=hb)
        met.append(run_sim(make_policy("DDS"), cfg).num_met)
    assert met[0] >= met[-1]


def test_overload_degrades_gracefully_not_catastrophically():
    """Under 4x overload the system still completes all tasks (no deadlock
    or loss), just missing deadlines."""
    res = run_sim(make_policy("DDS"), SimConfig(
        num_tasks=100, interval_ms=10, constraint_ms=800))
    finished = sum(1 for r in res.records
                   if r.finished_ms < float("inf") and not r.dropped)
    assert finished == 100                # nothing lost or stuck
    assert 0 < res.num_met < 100          # partial SLO attainment


# ------------------------------------------------------------ the live fleet
def _work(ms):
    def fn(task):
        time.sleep(ms / 1e3)
        return task.task_id
    return fn


def _mk_fleet(policy="DDS"):
    fleet = Fleet(make_policy(policy), source="rasp1",
                  coordinator="edge_server", heartbeat_ms=5,
                  required_apps=[FACE])
    fleet.add_worker(Worker(paper_raspberry_pi("rasp1", 2), {FACE: _work(5)}))
    fleet.add_worker(Worker(paper_edge_server(4), {FACE: _work(2)}))
    fleet.add_worker(Worker(paper_raspberry_pi("rasp2", 2), {FACE: _work(5)}))
    return fleet


def _submit_n(fleet, n, constraint=500.0, interval_s=0.002):
    done = []
    for i in range(n):
        t = Task(task_id=i, app_id=FACE, size_kb=29.0,
                 created_ms=time.monotonic() * 1e3,
                 constraint_ms=constraint, source="rasp1")
        fleet.submit(t, on_done=done.append)
        time.sleep(interval_s)
    deadline = time.monotonic() + 5.0
    while len(done) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return done


def test_simulated_and_live_dds_agree_qualitatively():
    """The same DDS policy behaves consistently in the simulator and on
    live workers: loose deadlines stay source-local."""
    loose = run_sim(make_policy("DDS"), SimConfig(
        num_tasks=20, interval_ms=700, constraint_ms=10_000))
    assert loose.placement_counts().get("rasp1", 0) == 20

    # live fleet, same shape of workload (scaled 100x faster)
    fleet = Fleet(make_policy("DDS"), source="rasp1",
                  coordinator="edge_server", heartbeat_ms=5,
                  required_apps=[FACE])
    fleet.add_worker(Worker(paper_raspberry_pi("rasp1", 2), {FACE: _work(5)}))
    fleet.add_worker(Worker(paper_edge_server(4), {FACE: _work(2)}))
    fleet.start()
    try:
        done = _submit_n(fleet, 10, constraint=10_000, interval_s=0.01)
        assert len(done) == 10
        assert all(c.node == "rasp1" for c in done)   # local-first held
    finally:
        fleet.stop()


def test_live_fleet_completes_all():
    fleet = _mk_fleet()
    fleet.start()
    try:
        done = _submit_n(fleet, 30)
        assert len(done) == 30
        assert all(c.error is None for c in done)
    finally:
        fleet.stop()


def test_live_fleet_worker_removal_midstream():
    """Elastic scale-in: removing a worker mid-run must not lose the fleet;
    subsequent tasks route around it."""
    fleet = _mk_fleet()
    fleet.start()
    try:
        done1 = _submit_n(fleet, 10)
        fleet.remove_worker("rasp2")
        done2 = _submit_n(fleet, 10)
        assert len(done1) == 10 and len(done2) == 10
        assert all(c.node != "rasp2" for c in done2)
    finally:
        fleet.stop()


def test_live_fleet_eods_placement_split():
    fleet = _mk_fleet("EODS")
    fleet.start()
    try:
        done = _submit_n(fleet, 20)
        places = {c.node for c in done}
        assert places == {"rasp1", "edge_server"}
    finally:
        fleet.stop()


def test_live_fleet_admission_rejects_infeasible():
    fleet = _mk_fleet()
    fleet.admission_margin = 1.0
    fleet.start()
    try:
        t = Task(task_id=0, app_id=FACE, size_kb=29.0,
                 created_ms=time.monotonic() * 1e3,
                 constraint_ms=10.0, source="rasp1")   # < floor
        assert fleet.submit(t) is False
        assert fleet.stats.rejected == 1
    finally:
        fleet.stop()


def test_live_fleet_link_loss_is_accounted():
    """A forwarded task whose link drops it (UDP semantics) is counted
    lost, never silently gone."""
    fleet = Fleet(make_policy("AOE"), source="rasp1",
                  coordinator="edge_server", heartbeat_ms=5,
                  required_apps=[FACE])
    fleet.add_worker(Worker(paper_raspberry_pi("rasp1", 2), {FACE: _work(1)}))
    fleet.add_worker(Worker(paper_edge_server(4), {FACE: _work(1)}),
                     link=Link(LinkProfile(loss_prob=1.0)))
    fleet.start()
    try:
        for i in range(5):
            assert fleet.submit(Task(
                task_id=i, app_id=FACE, size_kb=29.0,
                created_ms=time.monotonic() * 1e3, constraint_ms=10_000,
                source="rasp1")) is False
        assert fleet.stats.lost == 5 and fleet.stats.submitted == 5
        assert fleet.stats.placements == {}
    finally:
        fleet.stop()


def test_certification_rejects_bad_device():
    prof = paper_raspberry_pi("badpi", slots=0)
    ok, why = certify(prof, [FACE], min_slots=1)
    assert not ok and "slots" in why
    prof2 = paper_raspberry_pi("pi", slots=2)
    ok2, _ = certify(prof2, ["unknown_app"])
    assert not ok2

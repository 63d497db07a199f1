"""The port's serving engine and scheduler against the JAX package's on the
CPU: greedy streams of the port's ``Replica``/``ServingFleet`` token-
identical to the JAX ``Replica`` (granite-8b smoke, f32, identical weights)
with mid-stream joins; sampling filters, reproducibility and lane
independence; the copied DDS policies deciding as the originals do; and
the serve CLI on the CPU.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import latency as jlat
from repro.core import policies as jpol
from repro.core import profile as jprof
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving.sampling import _filter_logits as jfilter
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import latency as tlat
from repro_torch.core import policies as tpol
from repro_torch.core import profile as tprof
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as teng
from repro_torch.serving.overload import BrownoutConfig
from repro_torch.serving.sampling import NEG_INF
from repro_torch.serving.sampling import _filter_logits as tfilter
from repro_torch.sharding.mesh import make_mesh


@pytest.fixture(scope="module")
def setup():
    """Identical granite-8b smoke weights (f32) behind a JAX and a port
    replica, both with 2 lanes, capacity 64 and 4-token chunks."""
    torch.set_num_threads(2)
    jc = jget_smoke("granite-8b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    tc = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jrep = jeng.Replica("jax", jc, jp, slots=2, capacity=64,
                        prefill_chunk_tokens=4)
    trep = teng.Replica("torch", tc, tp, slots=2, capacity=64,
                        prefill_chunk_tokens=4)
    yield tc, tp, jrep, trep
    jrep.stop()
    trep.stop()


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32) for n in lens]


def _run_staggered(gen, reqs, gap_s=0.02):
    """Submit ``reqs`` from threads ``gap_s`` apart (later ones join lanes
    mid-stream) and return their token lists in order."""
    out = [None] * len(reqs)

    def run(i):
        time.sleep(i * gap_s)
        out[i] = gen(reqs[i]).tolist()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_replica_streams_match_jax_replica_with_midstream_joins(setup):
    """Four requests on two lanes, arriving while others decode: every
    greedy stream equals the JAX replica's, and the port's batch-1
    ``generate_sequential``."""
    tc, tp, jrep, trep = setup
    prompts = _prompts(tc.vocab_size, (10, 17, 6, 21), 11)
    new = [12, 6, 9, 5]
    reqs = [teng.Request(i, p, n, 1e9) for i, (p, n)
            in enumerate(zip(prompts, new))]
    jreqs = [jeng.Request(i, p, n, 1e9) for i, (p, n)
             in enumerate(zip(prompts, new))]
    got = _run_staggered(trep.generate, reqs)
    exp = _run_staggered(jrep.generate, jreqs)
    assert got == exp
    for r, g in zip(reqs, got):
        assert trep.generate_sequential(r).tolist() == g
    assert trep.decode_steps > 0 and trep.prefill_chunks > 0


def test_fleet_routes_and_accounts(setup):
    tc, tp, jrep, trep = setup
    fleet = teng.ServingFleet(tpol.make_policy("DDS"), source="torch",
                              coordinator="torch")
    fleet.add_replica(trep)
    prompt = np.arange(2, 10, dtype=np.int32)
    res = fleet.submit(teng.Request(50, prompt, 3, 1e9))
    assert res.ok and res.outcome == "ok" and res.replica == "torch"
    assert res.attempts == 1 and not res.failed_over and res.ttft_ms > 0
    assert res.tokens.tolist() == jrep.generate(
        jeng.Request(50, prompt, 3, 1e9)).tolist()
    assert fleet.stats["torch"] == 1
    assert trep.profile is not None and trep.profile.step_curve is not None
    # detach without stopping the module-shared replica
    fleet.monitor.stop()
    for pub in fleet._publishers.values():
        pub.stop()


def test_sampled_streams_reproducible_and_join_independent(setup):
    """A seeded sampled stream repeats exactly, and does not change when
    another request joins the batch mid-stream."""
    tc, tp, jrep, trep = setup
    prompt, other = _prompts(tc.vocab_size, (9, 13), 17)

    def sampled(rid):
        return teng.Request(rid, prompt, 10, 1e9, temperature=0.9,
                            top_p=0.95, seed=42)

    solo = trep.generate(sampled(60)).tolist()
    assert trep.generate(sampled(61)).tolist() == solo
    joined = _run_staggered(
        trep.generate, [sampled(62), teng.Request(63, other, 8, 1e9,
                                                  temperature=0.7, seed=5)],
        gap_s=0.03)
    assert joined[0] == solo
    assert len(set(solo)) > 1          # actually sampling, not stuck


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 1, 3, 7], [1.0, 1.0, 1.0, 1.0]),
    ([0, 0, 0, 0], [0.1, 0.5, 0.9, 0.999]),
    ([2, 0, 5, 1], [0.7, 0.3, 1.0, 0.95]),
])
def test_filter_logits_masks_match_jax(top_k, top_p):
    """Same kept set as the reference on the same logits, ties included
    (value-threshold semantics)."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[:, 10:14] = logits[:, [3]]                 # ties around the cut
    tk, tp_ = np.asarray(top_k, np.int32), np.asarray(top_p, np.float32)
    got = tfilter(torch.from_numpy(logits), torch.from_numpy(tk),
                  torch.from_numpy(tp_)).numpy()
    exp = np.asarray(jfilter(jnp.asarray(logits), jnp.asarray(tk),
                             jnp.asarray(tp_)))
    np.testing.assert_array_equal(got <= NEG_INF / 2, exp <= NEG_INF / 2)
    kept = got > NEG_INF / 2
    np.testing.assert_array_equal(got[kept], logits[kept])


def _profiles(prof_mod):
    """The paper's two devices plus a lane-mode serving replica, built
    from one package's ``core.profile``."""
    serve = prof_mod.AppProfile(
        app_id="serve", base_ms=40.0,
        contention=prof_mod.Curve([1.0, 2.0, 4.0], [40.0, 44.0, 52.0]),
        size_curve=prof_mod.Curve([8.0, 128.0], [40.0, 90.0]),
        reference_size=8.0,
        step_curve=prof_mod.Curve([1.0, 2.0, 4.0], [5.0, 5.5, 6.5]),
        tokens_per_task=8.0, prefill_chunk_ms=3.0, prefill_chunk_tokens=32.0)
    edge, rpi = prof_mod.paper_edge_server(), prof_mod.paper_raspberry_pi()
    rep = prof_mod.DeviceProfile("rep", 4, {"serve": serve})
    return edge, rpi, rep


@pytest.mark.parametrize("name", ["DDS", "DDS_EDF", "AOR", "AOE", "EODS",
                                  "JSQ"])
def test_copied_policies_decide_like_the_originals(name):
    """The port's copy of ``repro.core.policies`` picks the same node as
    the original over the same views, for random loads and deadlines."""
    rng = np.random.default_rng(3)
    sides = [(tpol, tlat, _profiles(tprof), tpol.make_policy(name)),
             (jpol, jlat, _profiles(jprof), jpol.make_policy(name))]
    for trial in range(60):
        app, idx = ((jprof.FACE, (0, 1)) if trial % 2 == 0
                    else ("serve", (2,)))
        task_kw = dict(task_id=trial, app_id=app,
                       size_kb=float(rng.integers(8, 260)), created_ms=0.0,
                       constraint_ms=float(rng.integers(50, 3000)),
                       source="src")
        states = [dict(running=int(rng.integers(0, 4)),
                       queued=int(rng.integers(0, 6)),
                       reserved=int(rng.integers(0, 2)))
                  for _ in range(3)]
        free = [int(rng.integers(0, 3)) for _ in range(3)]
        now = float(rng.integers(0, 40))
        decisions = []
        for pol_mod, lat, profs, policy in sides:
            views = [pol_mod.NodeView(profile=profs[idx[i % len(idx)]],
                                      state=lat.NodeState(**states[i]),
                                      free_slots=free[i]) for i in range(3)]
            task = lat.Task(**task_kw)
            decisions.append((
                policy.decide_source(task, now, views[0]),
                policy.decide_coordinator(task, now, views[1],
                                          {"n2": views[2]})))
        assert decisions[0] == decisions[1], trial


@pytest.mark.parametrize("fixed,per_token", [(10.0, 0.0), (0.0, 0.5),
                                              (3.0, 0.25)])
def test_chunk_cost_fit_does_not_scale_narrow_chunks(fixed, per_token):
    """Chunks of mixed widths costing ``fixed + per_token * w`` ms: the
    Update-Profile fit gives the reference chunk's cost within 2%, so a
    narrow tail chunk on the card (all fixed cost) does not inflate it,
    and a CPU-like cost (all per-token) is not deflated either."""
    prof = tprof.AppProfile("serve", 1.0, tprof.Curve([1.0], [1.0]),
                            prefill_chunk_ms=50.0, prefill_chunk_tokens=32.0)
    for w in (32, 32, 3, 1, 32, 8, 2, 1, 16, 32, 4, 1):
        prof.observe_prefill_chunk(fixed + per_token * w, tokens=w)
    want = fixed + per_token * 32
    assert prof.prefill_chunk_ms == pytest.approx(want, rel=0.02)
    assert prof.prefill_ms_per_token() == pytest.approx(want / 32, rel=0.02)


@pytest.mark.parametrize("mode", ["step_slo", "brownout"])
def test_chunk_cost_moves_when_every_chunk_is_narrow(setup, mode):
    """A binding step SLO (budget floored at 1 token) or brownout (ceiling
    halved) makes every chunk of a joining prompt narrower than the
    ceiling.  Each chunk still feeds the Update-Profile chunk cost, so an
    overestimated cost comes down instead of locking in the small budget
    it causes."""
    tc, tp, _, _ = setup
    ceiling = 8
    kw = (dict(step_slo_ms=1e-3) if mode == "step_slo" else
          dict(brownout=BrownoutConfig(budget_factor=0.5,
                                       restore_after=10 ** 9)))
    rep = teng.Replica("narrow", tc, tp, slots=2, capacity=64,
                       prefill_chunk_tokens=ceiling, **kw)
    if mode == "brownout":
        rep.brownout.engaged = True
    prof = tprof.AppProfile(
        "serve", 40.0, tprof.Curve([1.0, 2.0], [40.0, 44.0]),
        step_curve=tprof.Curve([1.0, 2.0], [1.0, 1.0]), tokens_per_task=8.0,
        prefill_chunk_ms=1000.0, prefill_chunk_tokens=float(ceiling))
    widths = []
    observe = prof.observe_prefill_chunk

    def record(ms, ewma=0.25, tokens=None):
        widths.append(tokens)
        observe(ms, ewma, tokens)

    prof.observe_prefill_chunk = record
    prompts = _prompts(tc.vocab_size, (4, 12), 5)
    # a decoding lane first, so the joining prompt is budgeted with a lane
    # in flight
    a = threading.Thread(target=rep.generate,
                         args=(teng.Request(0, prompts[0], 48, 1e9),))
    try:
        a.start()
        t_end = time.monotonic() + 60
        while rep.state().running == 0:
            assert time.monotonic() < t_end
            time.sleep(0.002)
        rep.profile = prof
        rep.generate(teng.Request(1, prompts[1], 2, 1e9))
        a.join(timeout=60)
    finally:
        rep.stop()
    assert widths == ([1] * 12 if mode == "step_slo" else [4, 4, 4])
    assert 0.0 < prof.prefill_chunk_ms < 500.0


def test_unported_replica_modes_raise(setup):
    """Sharded replicas are served (``tests/test_torch_mesh_serving.py``);
    the meshes a cache cannot be split over raise ``ValueError`` before
    any warmup, as the reference asserts: a ring whose slots (the
    capacity) do not divide by the sequence axis, and a paged pool whose
    rows (``num_pages`` and the dump row) do not."""
    tc, tp, _, _ = setup
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="do not split over 4"):
        teng.Replica("m", tc, tp, capacity=62, serving_mesh=mesh)
    with pytest.raises(ValueError, match="does not split over 4"):
        teng.Replica("m", tc, tp, capacity=64, paged=True, page_size=8,
                     num_pages=16, serving_mesh=mesh)


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--interval-ms", "1",
                 "--new-tokens", "4", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert "outcomes: ok=3 rejected=0 shed=0 lost=0" in out


@pytest.mark.parametrize("kind", ["crash", "hang", "slow", "partition"])
def test_serve_cli_chaos_on_cpu(capsys, kind):
    """``--chaos`` injects its fault into replica0 on the plan's clock and
    the run ends with a chaos summary: every request has a classified
    outcome (a request the slowed victim sheds under its deadline is one),
    and nothing is lost (crash, slow and partition) or the loss is
    counted."""
    n = 6
    tserve.main(["--device", "cpu", "--requests", str(n), "--interval-ms",
                 "60", "--new-tokens", "24", "--prompt-len", "12",
                 "--chaos", kind, "--chaos-at-ms", "100"])
    out = capsys.readouterr().out
    assert f"chaos: {kind} on replica0 at t+100ms" in out
    summary = [ln for ln in out.splitlines()
               if ln.startswith("chaos summary:")]
    assert len(summary) == 1, out
    fields = dict(kv.split("=", 1) for kv in summary[0].split()[2:6])
    outcomes = [ln for ln in out.splitlines() if ln.startswith("outcomes:")]
    counts = dict(kv.split("=") for kv in outcomes[0].split()[1:5])
    assert sum(int(v) for v in counts.values()) == n
    assert int(fields["lost"]) == int(counts["lost"])
    assert int(fields["failed"]) == sum(int(counts[k]) for k in
                                        ("rejected", "shed", "lost"))
    if kind != "hang":
        assert fields["lost"] == "0", out
    if kind == "slow":
        assert "dead=[]" in summary[0]


def test_minicpm_smoke_streams_match_jax_replica():
    """minicpm-2b (MHA, tied embeddings, an odd vocab at full width) through
    the port's replica: greedy streams with mid-stream joins equal the JAX
    replica's on the same f32 smoke weights."""
    jc = jget_smoke("minicpm-2b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    tc = get_smoke_config("minicpm-2b").replace(dtype=torch.float32)
    assert tc.num_kv_heads == tc.num_heads and tc.tie_embeddings
    jp = JM.init_model(jax.random.PRNGKey(1), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jrep = jeng.Replica("jax", jc, jp, slots=2, capacity=64,
                        prefill_chunk_tokens=4)
    trep = teng.Replica("torch", tc, tp, slots=2, capacity=64,
                        prefill_chunk_tokens=4)
    try:
        prompts = _prompts(tc.vocab_size, (9, 14, 5), 23)
        new = [10, 7, 8]
        got = _run_staggered(trep.generate, [
            teng.Request(i, p, k, 1e9)
            for i, (p, k) in enumerate(zip(prompts, new))])
        exp = _run_staggered(jrep.generate, [
            jeng.Request(i, p, k, 1e9)
            for i, (p, k) in enumerate(zip(prompts, new))])
        assert got == exp
        assert [len(g) for g in got] == new
    finally:
        jrep.stop()
        trep.stop()


@pytest.mark.parametrize("mode", ["ring", "paged", "prefix"])
def test_musicgen_smoke_streams_match_jax_replica(mode):
    """musicgen-medium (MHA, a gelu MLP, an untied head) through the port's
    replica in ring mode, paged, and paged with the prefix cache (the
    first request registers a page-aligned system prompt the second
    reuses): greedy streams with mid-stream joins equal the JAX replica's
    in the same mode on the same f32 smoke weights."""
    jc = jget_smoke("musicgen-medium").replace(dtype=jnp.float32,
                                               param_dtype=jnp.float32)
    tc = get_smoke_config("musicgen-medium").replace(dtype=torch.float32)
    assert tc.mlp_kind == "gelu" and not tc.tie_embeddings
    jp = JM.init_model(jax.random.PRNGKey(2), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    kw = dict(slots=2, capacity=48, prefill_chunk_tokens=8)
    if mode != "ring":
        kw.update(paged=True, page_size=8, prefix_cache=mode == "prefix")
    jrep = jeng.Replica("jax", jc, jp, **kw)
    trep = teng.Replica("torch", tc, tp, **kw)
    try:
        rng = np.random.default_rng(29)
        sysp = rng.integers(2, tc.vocab_size, 16)
        prompts = [np.concatenate([sysp, rng.integers(2, tc.vocab_size, n)])
                   .astype(np.int32) for n in (5, 9)]
        prompts += _prompts(tc.vocab_size, (21, 6), 31)
        new = [10, 7, 9, 5]
        got, exp = [], []
        for mod, rep, out in ((teng, trep, got), (jeng, jrep, exp)):
            reqs = [mod.Request(i, p, n, 1e9)
                    for i, (p, n) in enumerate(zip(prompts, new))]
            out.append(rep.generate(reqs[0]).tolist())
            out.extend(_run_staggered(rep.generate, reqs[1:]))
        assert got == exp
        assert [len(g) for g in got] == new
        if mode == "prefix":
            assert trep._prefix.hits > 0 and jrep._prefix.hits > 0
    finally:
        jrep.stop()
        trep.stop()


@pytest.mark.parametrize("extra", [[], ["--paged"], ["--prefix-cache"]])
def test_serve_cli_runs_musicgen_on_cpu(capsys, extra):
    tserve.main(["--device", "cpu", "--arch", "musicgen-medium", "--requests",
                 "3", "--interval-ms", "1", "--new-tokens", "4",
                 "--prompt-len", "20"] + extra)
    out = capsys.readouterr().out
    assert "outcomes: ok=3 rejected=0 shed=0 lost=0" in out

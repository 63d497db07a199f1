"""Sharded replicas (``Replica(serving_mesh=...)``) on the CPU.

* A replica on a (1, 4) mesh of CPU devices, ring and paged (with the
  prefix cache: a restore and a copy-on-write across shards), a lane
  joining mid-stream and a prompt whose ring spans three of the four
  shards: its greedy tokens equal the JAX reference *functions*
  (``M.prefill`` + ``M.decode_step``; the JAX test of the mesh replica,
  ``test_distributed.py::test_mesh_replica_tokens_match_single_device_reference``,
  fails on every run of the driver, so the functions are the reference)
  on identical weights (granite-8b smoke, f32).  Its sampled streams
  repeat across runs and equal the unsharded port replica's (sampled
  streams are compared port against port: the packages draw differently).
* A DDS fleet of a sharded and an unsharded replica serves every request.
* On the card's route (``ops._route`` patched, every launcher its plain
  twin), a decode step under the mesh launches the partials kernel once a
  shard and the combine once per attention layer, and the ordinary
  decode kernels never: the counts ``chip_smoke.expected_launches`` holds
  the card to.

``tests/test_torch_spmd_decode.py`` holds the spmd functions themselves.
"""
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.policies import make_policy
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pk
from repro_torch.kernels import rmsnorm as rk
from repro_torch.models import model as TM
from repro_torch.serving import engine as teng
from repro_torch.serving import spmd_decode as spmd
from repro_torch.sharding import context as shctx
from repro_torch.sharding.mesh import make_mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CAP, PAGE = 64, 4


def _mesh():
    return make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    jc = jget_smoke("granite-8b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    tc = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, jp, tc, tp


def _jax_greedy(jc, jp, prompt, new):
    """The reference functions: whole-prompt prefill, then one decode step
    a token (single device)."""
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    logits, cache = JM.prefill(jp, jnp.asarray(prompt)[None], jc,
                               capacity=CAP)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = []
    for i in range(new):
        out.append(int(tok[0, 0]))
        logits, cache = step(jp, cache, tok, len(prompt) + i)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    return out


def _prompts(vocab):
    """A 10-token prompt, one of 50 (its ring spans slots 0-49: three of
    the four 16-slot shards) and a 17-token late joiner."""
    rng = np.random.default_rng(11)
    return [rng.integers(2, vocab, size=(n,)).astype(np.int32)
            for n in (10, 50, 17)]


def _staggered(rep, prompts, news):
    """Greedy streams, the last request joining while the others decode."""
    out = [None] * len(prompts)

    def go(i):
        if i == len(prompts) - 1:
            time.sleep(0.05)
        out[i] = rep.generate(teng.Request(i, prompts[i], news[i],
                                           1e9)).tolist()
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("mode", ["ring", "paged"])
def test_mesh_replica_tokens_match_jax_functions(setup, mode):
    jc, jp, tc, tp = setup
    kw = (dict(paged=True, page_size=PAGE, num_pages=47, prefix_cache=True)
          if mode == "paged" else {})
    rep = teng.Replica("mesh0", tc, tp, slots=2, capacity=CAP,
                       prefill_chunk_tokens=4, serving_mesh=_mesh(), **kw)
    prompts, news = _prompts(tc.vocab_size), [12, 6, 5]
    if mode == "paged":
        # a sharer of the first prompt's two leading pages (restored from
        # the pool), and those two pages alone: a full hit, copied on write
        prompts += [np.concatenate([prompts[0][:8], prompts[2][:5]]),
                    prompts[0][:8].copy()]
        news += [4, 4]
    try:
        assert isinstance(rep._cache[0]["k"], spmd.Sharded)
        got = _staggered(rep, prompts[:3], news[:3])
        if mode == "paged":
            got += [rep.generate(teng.Request(10 + i, p, n, 1e9)).tolist()
                    for i, (p, n) in enumerate(zip(prompts[3:], news[3:]))]
            assert rep.cow_copies >= 1 and rep._prefix.hits >= 1
        want = [_jax_greedy(jc, jp, p, n) for p, n in zip(prompts, news)]
        assert got == want
        assert rep.generate_sequential(
            teng.Request(20, prompts[1], 6, 1e9)).tolist() == want[1]
    finally:
        rep.stop()


def test_mesh_replica_sampled_streams(setup):
    """Fixed-seed sampled requests on the mesh: the same stream twice, and
    the unsharded port replica's stream."""
    _, _, tc, tp = setup
    prompt = _prompts(tc.vocab_size)[1]
    req = lambda i: teng.Request(i, prompt, 6, 1e9, temperature=0.8,
                                 top_p=0.95, seed=5)
    mesh_rep = teng.Replica("mesh0", tc, tp, slots=2, capacity=CAP,
                            prefill_chunk_tokens=4, serving_mesh=_mesh())
    plain = teng.Replica("plain0", tc, tp, slots=2, capacity=CAP,
                         prefill_chunk_tokens=4)
    try:
        a = mesh_rep.generate(req(0)).tolist()
        b = mesh_rep.generate(req(1)).tolist()
        assert a == b == plain.generate(req(2)).tolist()
    finally:
        mesh_rep.stop()
        plain.stop()


def test_fleet_of_sharded_and_unsharded_replicas(setup):
    """A DDS fleet of a sharded and an unsharded replica (the card's phase
    14 in miniature): every request ``ok``, each stream equal to the
    unsharded replica's ``generate_sequential``."""
    _, _, tc, tp = setup
    fleet = teng.ServingFleet(make_policy("DDS"), source="replica0",
                              coordinator="replica1")
    reps = [teng.Replica("replica0", tc, tp, slots=2, capacity=CAP,
                         prefill_chunk_tokens=4, serving_mesh=_mesh()),
            teng.Replica("replica1", tc, tp, slots=2, capacity=CAP,
                         prefill_chunk_tokens=4)]
    for r in reps:
        fleet.add_replica(r)
    assert reps[0].profile.step_curve is not None
    prompts = _prompts(tc.vocab_size)
    try:
        res = [None] * len(prompts)

        def go(i):
            res[i] = fleet.submit(teng.Request(i, prompts[i], 5, 1e9))
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for p, r in zip(prompts, res):
            assert r.outcome == "ok"
            assert r.tokens.tolist() == reps[1].generate_sequential(
                teng.Request(9, p, 5, 1e9)).tolist()
    finally:
        fleet.stop()


# -------------------------------------------- launches on the card's route
def _fake_card(monkeypatch, calls):
    """CPU tensors take the card's route; each launcher is its plain twin,
    counted in ``calls`` under ``ops.kernel_launches``' key."""
    monkeypatch.setattr(ops, "_route", lambda t: True)
    table = [
        (dk, "decode_attention", dk.decode_attention_plain, "decode_attention"),
        (dk, "decode_attention_partials", dk.decode_attention_partials_plain,
         "decode_attention_partials"),
        (dk, "attention_combine", dk.attention_combine_plain,
         "attention_combine"),
        (pk, "paged_decode_attention", pk.paged_decode_attention_plain,
         "paged_decode_attention"),
        (pk, "paged_decode_attention_partials",
         pk.paged_decode_attention_partials_plain,
         "paged_decode_attention_partials"),
        (fk, "flash_attention", fk.flash_attention_plain, "flash_attention")]
    table += [(rk, n, getattr(rk, n + "_plain"), "rmsnorm")
              for n in ("rmsnorm", "rmsnorm_pair", "add_rmsnorm",
                        "gated_rmsnorm")]
    for mod, name, plain, key in table:
        def launcher(*a, _plain=plain, _key=key, splits=None, **k):
            calls[_key] = calls.get(_key, 0) + 1
            if _key.endswith("_partials"):
                k["splits"] = splits or 1
            return _plain(*a, **k)
        monkeypatch.setattr(mod, name, launcher)


@pytest.mark.parametrize("paged", [False, True])
def test_mesh_step_launches_match_expected(setup, monkeypatch, paged):
    """One prefill chunk and two decode steps under a (1, 4) mesh on the
    card's route: per step and attention layer four partials launches and
    one combine, no ordinary decode launch; tokens as on the CPU route."""
    _, _, tc, tp = setup
    mesh = _mesh()
    steps = 2
    tok = torch.tensor([[5], [9]])
    idx = torch.tensor([3, 7], dtype=torch.int32)

    def run():
        lane = TM.init_cache(tc, 1, CAP, "cpu")
        TM.prefill_chunk(tp, lane, torch.tensor([[3, 4, 5, 6]]), 0, tc)
        if paged:
            cache = TM.init_paged_cache(tc, 2, CAP, 31, PAGE, "cpu")
            tables = torch.arange(2 * (CAP // PAGE), dtype=torch.int32
                                  ).reshape(2, -1) % 31
        else:
            cache, tables = TM.init_cache(tc, 2, CAP, "cpu"), None
        cache = spmd.shard_cache(cache, mesh, paged=paged)
        out = []
        with shctx.serving_mesh(mesh):
            for s in range(steps):
                lg, cache = TM.decode_step(tp, cache, tok, idx + s, tc,
                                           block_tables=tables)
                out.append(lg)
        return torch.stack(out)

    want = run()
    calls = {}
    _fake_card(monkeypatch, calls)
    got = run()
    assert torch.allclose(got, want, atol=1e-5, rtol=0)
    expect = chip_smoke.expected_launches(tc, steps, 1, 0, paged=paged,
                                          n_seq=4)
    assert {k: calls.get(k, 0) for k in expect if expect[k] or k in calls} \
        == {k: v for k, v in expect.items() if v or k in calls}
    attn = tc.layer_kinds().count("attn")
    part = "paged_decode_attention_partials" if paged \
        else "decode_attention_partials"
    assert calls[part] == 4 * attn * steps
    assert calls["attention_combine"] == attn * steps

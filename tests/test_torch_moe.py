"""The port's mixture-of-experts FFN against the JAX package's on the CPU:
``models.moe.moe_ffn`` against ``repro.models.moe.moe_ffn`` on bridged
smoke weights (mixtral-8x22b: 4 experts; arctic-480b: 8 experts and its
dense FFN) at ample, published and floor capacity, one and four groups,
f32 and bf16; the router's ties and the drop order; the token-by-token
``ref.moe_ffn_reference``; ``expert_capacity``; the seeded init; a
fixed-composition batched decode step where choices drop; replica streams
against the JAX replica (mixtral ring, arctic paged with the prefix
cache); and the serve CLI for both archs.

Tolerances: f32 outputs are O(1) and both sides compute the same math in
another summation order, so 1e-5 absolute plus 1e-5 relative, the aux
loss 1e-6; bf16 outputs are rounded at the same points on both sides, so
two bf16 roundings of the largest |reference| (2^-7 x max(1, max|ref|));
logits 1e-4 as in ``tests/test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as lyr
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving import engine as teng

ARCHS = ["mixtral-8x22b", "arctic-480b"]
TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def stacks():
    """arch -> (jax cfg, jax params, port cfg, port model), f32 smoke."""
    torch.set_num_threads(2)
    out = {}
    for arch in ARCHS:
        jc = jget_smoke(arch).replace(dtype=jnp.float32,
                                      param_dtype=jnp.float32)
        tc = get_smoke_config(arch).replace(dtype=torch.float32)
        jp = jax.jit(lambda key: JM.init_model(key, jc))(
            jax.random.PRNGKey(0))
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
        out[arch] = (jc, jp, tc, tp)
    return out


# the reference function, compiled once per (config, groups)
_jmoe = jax.jit(JMOE.moe_ffn, static_argnums=(2, 3))


def _layer0(stack, dtype=torch.float32):
    """Layer 0's MoE leaves: the JAX dict (f32 masters) and the port's
    ``Experts`` in ``dtype`` (bridged, so the bf16 values are the masters
    rounded as JAX's cast rounds them)."""
    jc, jp, tc, tp = stack
    jl = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                      jp["periods"][0]["moe"])
    if dtype == torch.float32:
        return jl, tp.layers[0].moe
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     tc.replace(dtype=dtype), "cpu")
    return jl, model.layers[0].moe


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _JDT[dtype]), torch.from_numpy(x).to(dtype)


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _zero_rows(y):
    return np.abs(y).max(-1) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("factor", ["ample", "published", "floor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(stacks, arch, factor, groups, dtype):
    """The same outputs, aux loss and dropped rows as the JAX package at
    capacity factor E (nothing drops), the published 1.25 and 0.01 (every
    expert at the floor capacity of 4), in one group and in four.  The
    dropped rows are compared with the dense FFN left out (arctic's would
    fill them)."""
    stack = stacks[arch]
    jc, _, tc, _ = stack
    cf = {"ample": float(tc.num_experts), "published": 1.25,
          "floor": 0.01}[factor]
    p_j, p_t = _layer0(stack, dtype)
    x_j, x_t = _x((2, 24, tc.d_model), 5, dtype)
    out = {}
    for dense in ((True, False) if tc.moe_dense_ff else (False,)):
        kw = dict(moe_capacity_factor=cf)
        if not dense:
            kw["moe_dense_ff"] = 0
        jcc = jc.replace(dtype=_JDT[dtype], **kw)
        tcc = tc.replace(dtype=dtype, **kw)
        jy, jaux = _jmoe(p_j, x_j, jcc, groups)
        ty, taux = TMOE.moe_ffn(p_t, x_t, tcc, num_groups=groups)
        out[dense] = (np.asarray(jy.astype(jnp.float32)), float(jaux),
                      ty.float().numpy(), float(taux))
    jy, jaux, ty, taux = out[bool(tc.moe_dense_ff)]
    assert ty.shape == (2, 24, tc.d_model)
    if dtype == torch.float32:
        np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    else:
        assert np.abs(ty - jy).max() <= 2.0 ** -7 * max(1.0,
                                                        np.abs(jy).max())
    assert abs(taux - jaux) <= 1e-6
    jy0, _, ty0, _ = out[False]
    np.testing.assert_array_equal(_zero_rows(ty0), _zero_rows(jy0))
    _, kept = ref.moe_ffn_reference(p_t, x_t, tc.replace(
        dtype=dtype, moe_capacity_factor=cf), num_groups=groups)
    choices = 48 * tc.num_experts_per_tok
    if factor == "ample":
        assert len(kept) == choices
    if factor == "floor":
        assert len(kept) < choices


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_choose_the_lower_expert_as_lax_top_k(stacks, arch):
    """Every router column but the first made equal: each token's choices
    are decided by the tie rule, and the port picks the experts
    ``jax.lax.top_k`` picks (the lower index), so its outputs equal JAX's."""
    stack = stacks[arch]
    jc, _, tc, _ = stack
    p_j, p_t = _layer0(stack)
    router = np.asarray(p_j["router"]).copy()
    router[:, 2:] = router[:, 1:2]
    p_j = dict(p_j, router=jnp.asarray(router))
    saved = p_t.router.clone()
    try:
        p_t.router.copy_(torch.from_numpy(router))
        x_j, x_t = _x((1, 16, tc.d_model), 6, torch.float32)
        probs = jax.nn.softmax(x_j @ p_j["router"], axis=-1)
        jw, je = jax.lax.top_k(probs, tc.num_experts_per_tok)
        tw, te = TMOE.top_k(torch.from_numpy(np.array(probs)),
                            tc.num_experts_per_tok)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert (np.asarray(je) >= 1).any() and (np.asarray(je) <= 2).any()
        jy, _ = _jmoe(p_j, x_j, jc, 1)
        ty, _ = TMOE.moe_ffn(p_t, x_t, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
    finally:
        p_t.router.copy_(saved)


def test_top_k_tie_order_matches_lax_top_k():
    """Rows full of ties, a NaN-free random mix of repeated values: the
    same indices as ``jax.lax.top_k`` at every k."""
    rng = np.random.default_rng(3)
    probs = rng.choice([0.1, 0.2, 0.3], size=(64, 8)).astype(np.float32)
    for k in (1, 2, 3, 8):
        _, je = jax.lax.top_k(jnp.asarray(probs), k)
        tw, te = TMOE.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tw.numpy(),
                                      np.take_along_axis(probs, te.numpy(),
                                                         -1))


@pytest.mark.parametrize("arch", ARCHS)
def test_identical_rows_drop_in_token_order(stacks, arch):
    """Rows made identical choose the same experts, so at the published
    factor every expert overflows: the first ``capacity`` tokens keep both
    choices and the rest keep none, on both sides (the reference's kept
    pairs say which), and the outputs equal JAX's.  Then rows of three
    kinds in a random order at the floor factor, where tokens lose one
    choice and keep the other: the outputs equal JAX's."""
    stack = stacks[arch]
    jc, _, tc, _ = stack
    p_j, p_t = _layer0(stack)
    k = tc.num_experts_per_tok
    one = np.random.default_rng(8).standard_normal(tc.d_model)
    x = np.broadcast_to(one, (1, 32, tc.d_model)).astype(np.float32)
    jy, _ = _jmoe(p_j, jnp.asarray(x), jc, 1)
    ty, _ = TMOE.moe_ffn(p_t, torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    cap = min(TMOE.expert_capacity(32, tc), 32 * k)
    _, kept = ref.moe_ffn_reference(p_t, torch.from_numpy(x), tc)
    assert cap < 32
    assert kept == [(i, c) for i in range(cap) for c in range(k)]
    if not tc.moe_dense_ff:
        assert not _zero_rows(ty.numpy()[0, :cap]).any()
        assert _zero_rows(ty.numpy()[0, cap:]).all()
        assert _zero_rows(np.asarray(jy)[0, cap:]).all()
    kinds = np.random.default_rng(9).standard_normal((3, tc.d_model))
    order = np.random.default_rng(10).integers(0, 3, 48)
    x = kinds[order][None].astype(np.float32)
    cfg_j, cfg_t = (c.replace(moe_capacity_factor=0.01) for c in (jc, tc))
    jy, _ = _jmoe(p_j, jnp.asarray(x), cfg_j, 1)
    ty, _ = TMOE.moe_ffn(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    _, kept = ref.moe_ffn_reference(p_t, torch.from_numpy(x), cfg_t)
    assert 0 < len(kept) < 48 * k


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("factor", [1.25, 0.01])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_loop_matches_moe_ffn(stacks, arch, factor, groups):
    """``ref.moe_ffn_reference``, token by token, gives ``moe_ffn``'s
    output; every kept (token, choice) is one of the token's top k, and
    no expert serves more than its capacity in a group."""
    stack = stacks[arch]
    _, _, tc, _ = stack
    tc = tc.replace(moe_capacity_factor=factor)
    _, p_t = _layer0(stack)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 16, tc.d_model)).astype(np.float32))
    y, _ = TMOE.moe_ffn(p_t, x, tc, num_groups=groups)
    r, kept = ref.moe_ffn_reference(p_t, x, tc, num_groups=groups)
    np.testing.assert_allclose(r.numpy(), y.numpy(), atol=TOL, rtol=TOL)
    cap = min(TMOE.expert_capacity(48 // groups, tc),
              48 // groups * tc.num_experts_per_tok)
    probs = torch.softmax(x.reshape(48, -1) @ p_t.router, -1)
    _, top = TMOE.top_k(probs, tc.num_experts_per_tok)
    served = {}
    for i, c in kept:
        key = (i // (48 // groups), int(top[i, c]))
        served[key] = served.get(key, 0) + 1
    assert max(served.values()) <= cap


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_jax(arch):
    jc, tc = jget_smoke(arch), get_smoke_config(arch)
    for cf in (0.01, 0.5, 1.0, 1.25, 2.0, float(tc.num_experts)):
        for tokens in list(range(1, 70)) + [127, 128, 129, 1000, 4096]:
            assert TMOE.expert_capacity(
                tokens, tc.replace(moe_capacity_factor=cf)) == \
                JMOE.expert_capacity(tokens, jc.replace(
                    moe_capacity_factor=cf))


def test_init_is_seeded_scaled_and_drawn_expert_by_expert(monkeypatch):
    """Same seed, same experts; fan-in std 1/sqrt(d) for ``w_gate`` and
    ``w_up`` and 1/sqrt(f) for ``w_down`` (sample std ~0.88 of that at a
    cut of 2 std), the router's 1/sqrt(d); and no draw is larger than one
    expert's slice (no float32 temporary of a whole expert tensor)."""
    cfg = get_smoke_config("arctic-480b").replace(d_model=256, d_ff=512,
                                                  moe_dense_ff=384)
    shapes = []
    draw = lyr.dense_init_

    def spy(t, in_axis, gen):
        shapes.append(tuple(t.shape))
        draw(t, in_axis, gen)

    monkeypatch.setattr(lyr, "dense_init_", spy)
    a = TM.init_model(cfg, 7, "cpu")
    monkeypatch.undo()
    b = TM.init_model(cfg, 7, "cpu")
    experts = a.layers[0].moe.w_gate.shape[0]
    assert not any(len(s) == 3 and s[0] == experts for s in shapes)
    assert shapes.count((256, 512)) == 2 * 2 * experts   # gate, up; 2 layers
    assert shapes.count((512, 256)) == 2 * experts
    assert torch.equal(a.layers[1].moe.w_down, b.layers[1].moe.w_down)
    moe = a.layers[0].moe
    for name, fan_in in (("w_gate", 256), ("w_up", 256), ("w_down", 512),
                         ("router", 256)):
        w = moe[name].float()
        assert abs(float(w.std()) * fan_in ** 0.5 - 0.88) < 0.05, name
        assert float(w.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6, name
    assert not torch.equal(moe.w_gate[0], moe.w_gate[1])
    assert moe.dense["w_up"].shape == (256, 384)
    assert moe.router.dtype == cfg.dtype


def test_batched_decode_with_drops_matches_jax(stacks):
    """arctic-480b smoke at the published factor: 8 lanes prefilled with
    one prompt, then 8 batched decode steps.  Every lane routes to the
    same experts, so at a capacity of 4 each step drops the later lanes'
    choices: the lanes' logits part after the first step, and tokens and
    logits equal JAX's ``decode_step`` at this composition."""
    jc, jp, tc, tp = stacks["arctic-480b"]
    prompt = np.random.default_rng(12).integers(2, tc.vocab_size, 12)
    toks = np.broadcast_to(prompt, (8, 12)).astype(np.int32)
    cap = 32
    jl, jcache = jax.jit(lambda p, t: JM.prefill(p, t, jc, cap))(
        jp, jnp.asarray(toks))
    tl, tcache = TM.prefill(tp, torch.from_numpy(toks).long(), tc, cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1)[:, None]
    parted = False
    for i in range(8):
        jl, jcache = jdecode(jp, jcache, jt, 12 + i)
        tl, tcache = TM.decode_step(tp, tcache, tt, 12 + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        assert tt.numpy().tolist() == np.asarray(jt).tolist()
        parted |= not torch.equal(tl[0], tl[7])
    assert parted


def _staggered(gen, reqs, gap_s=0.02):
    import threading
    import time
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


@pytest.mark.parametrize("arch,paged", [("mixtral-8x22b", False),
                                        ("arctic-480b", True)])
def test_replica_streams_match_jax_replica(stacks, arch, paged):
    """Greedy streams with mid-stream joins equal the JAX replica's:
    mixtral through the ring (its 16-slot local rings wrap), arctic paged
    with the prefix cache (the first request registers a page-aligned
    system prompt that the second reuses).  At capacity factor E nothing drops, so the lanes cannot
    affect one another and the streams do not depend on when a request
    joins (at the published factor the free lanes' stale tokens compete
    for expert slots in both packages)."""
    jc, jp, tc, tp = stacks[arch]
    e = float(tc.num_experts)
    jc, tc = (c.replace(moe_capacity_factor=e) for c in (jc, tc))
    kw = dict(slots=2, capacity=48, prefill_chunk_tokens=8)
    if paged:
        kw.update(paged=True, page_size=8, prefix_cache=True)
    jrep = jeng.Replica("jax", jc, jp, **kw)
    trep = teng.Replica("torch", tc, tp, **kw)
    try:
        rng = np.random.default_rng(13)
        sysp = rng.integers(2, tc.vocab_size, 16)
        prompts = [np.concatenate([sysp, rng.integers(2, tc.vocab_size, n)])
                   for n in (5, 9)]
        prompts += [rng.integers(2, tc.vocab_size, n) for n in (21, 6)]
        prompts = [p.astype(np.int32) for p in prompts]
        new = [12, 7, 9, 5]
        got, exp = [], []
        for mod, rep, out in ((teng, trep, got), (jeng, jrep, exp)):
            reqs = [mod.Request(i, p, n, 1e9)
                    for i, (p, n) in enumerate(zip(prompts, new))]
            # the first alone (with the prefix cache it registers the
            # system prompt), then the others joining one another
            out.append(rep.generate(reqs[0]).tolist())
            out.extend(_staggered(rep.generate, reqs[1:]))
        assert got == exp
        assert [len(g) for g in got] == new
        if paged:
            assert trep._prefix.hits > 0 and jrep._prefix.hits > 0
    finally:
        jrep.stop()
        trep.stop()


@pytest.mark.parametrize("arch,extra", [("mixtral-8x22b", []),
                                        ("arctic-480b", ["--prefix-cache"])])
def test_serve_cli_runs_moe_on_cpu(capsys, arch, extra):
    tserve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                 "--interval-ms", "1", "--new-tokens", "4",
                 "--prompt-len", "20"] + extra)
    out = capsys.readouterr().out
    assert "outcomes: ok=3 rejected=0 shed=0 lost=0" in out


def test_configs_keep_published_moe_fields():
    """Both archs resolve, with the published expert counts, top-k,
    capacity factor and arctic's dense FFN (the whole config is held
    against JAX in ``tests/test_torch_model.py``)."""
    for arch, want in {"mixtral-8x22b": (8, 2, 0, 1.25),
                       "arctic-480b": (128, 2, 4864, 1.25)}.items():
        cfg = get_config(arch)
        assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_dense_ff,
                cfg.moe_capacity_factor) == want

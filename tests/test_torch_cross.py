"""Cross-attention in the port against the JAX package on the CPU:
``models.attention.cross_attention``/``cross_kv``, the llama-3.2-vision
smoke stack's ``forward``, ``prefill`` and ``decode_step`` over stub encoder
states, the cross decode's plain route, the bridge over two pattern
periods, and the refusals (no ``enc``, a replica or the serve CLI on a
cross stack).

Both packages get the same numpy-seeded inputs and bridged weights, and
``enc`` in ``cfg.dtype`` (the port casts ``enc`` to it; the reference's
einsum would promote a wider one).  Tolerances: f32 1e-5 for one layer,
logits 1e-4 for the stack (O(1-10), the same f32 math summed in another
order), greedy tokens identical; bf16 2^-7 x max(1, |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import model as JM
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.common.config import CROSS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serving import engine as teng

ARCH = "llama-3.2-vision-90b"
TOL = 1e-4


def _cfgs(**kw):
    jc = jget_smoke(ARCH).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                                  **kw)
    tc = get_smoke_config(ARCH).replace(dtype=torch.float32, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def stack():
    """(jax cfg, jax params, port cfg, port model): the f32 smoke stack of
    one period (4 self + 1 cross layers), weights bridged from JAX."""
    torch.set_num_threads(2)
    jc, tc = _cfgs()
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, jp, tc, tp


def _enc(b, cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _prompt(n, vocab, seed):
    return np.random.default_rng(seed).integers(
        2, vocab, size=(n,)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("s,cached", [(6, False), (6, True), (1, True),
                                      (1, False)])
def test_cross_attention_and_kv_match_jax(qk_norm, s, cached):
    """One cross layer on the same weights: ``cross_kv`` equals JAX's, and
    ``cross_attention`` from ``enc`` or from cached K/V (one query over
    the cache is the decode kernel's contiguous form, more go through
    flash) equals JAX's output and returned K/V."""
    jc, tc = _cfgs(use_qk_norm=qk_norm, num_image_tokens=11)
    jp = jattn.init_attention(jax.random.PRNGKey(3), jc, cross=True)
    if qk_norm:     # nonzero gains, so the (1 + scale) matters
        rng = np.random.default_rng(5)
        for n in ("q_norm", "k_norm"):
            jp[n] = {"scale": jnp.asarray(0.3 * rng.standard_normal(
                jc.resolved_head_dim), jnp.float32)}
    tp = {k: _t(np.asarray(v)) for k, v in jp.items() if "norm" not in k}
    if qk_norm:
        tp.update({n: _t(np.asarray(jp[n]["scale"]))
                   for n in ("q_norm", "k_norm")})
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    enc = _enc(2, jc, 8)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(enc), jc)
    tk, tv = tattn.cross_kv(tp, _t(enc), tc)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    jkv = (jk, jv) if cached else None
    tkv = (tk, tv) if cached else None
    jy, (jk2, jv2) = jattn.cross_attention(jp, jnp.asarray(x),
                                           None if cached else jnp.asarray(enc),
                                           jc, kv_cached=jkv)
    ty, (tk2, tv2) = tattn.cross_attention(tp, _t(x),
                                           None if cached else _t(enc), tc,
                                           kv_cached=tkv)
    assert ty.shape == (2, s, jc.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tk2.numpy(), np.asarray(jk2), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), atol=1e-5,
                               rtol=1e-5)


def test_forward_with_enc_matches_jax(stack):
    """B=2 with distinct encoder states: logits within 1e-4 of JAX's, and
    the rows differ (each row attends over its own ``enc``)."""
    jc, jp, tc, tp = stack
    toks = np.stack([_prompt(20, tc.vocab_size, s) for s in (1, 1)])
    enc = _enc(2, tc, 2)
    jl, _ = JM.forward(jp, jnp.asarray(toks), jc, enc=jnp.asarray(enc))
    tl, aux = TM.forward(tp, _t(toks).long(), tc, enc=_t(enc))
    assert tl.shape == (2, 20, tc.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert float((tl[0] - tl[1]).abs().max()) > 1e-3


def test_prefill_then_decode_token_identical_to_jax(stack):
    """``prefill(enc)`` then 8 greedy ``decode_step``s over the cached
    encoder K/V, B=2 with distinct ``enc``: the same tokens as JAX's, every
    step's logits within 1e-4; the cross caches hold ``cross_kv`` of
    ``enc``, have no ``pos``, and decoding leaves them as they were."""
    jc, jp, tc, tp = stack
    prompt = np.stack([_prompt(13, tc.vocab_size, 3),
                       _prompt(13, tc.vocab_size, 4)])
    enc = _enc(2, tc, 5)
    cap = 32
    jl, jcache = jax.jit(lambda p, t, e: JM.prefill(p, t, jc, cap, enc=e))(
        jp, jnp.asarray(prompt), jnp.asarray(enc))
    tl, tcache = TM.prefill(tp, _t(prompt).long(), tc, cap, enc=_t(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    cross = [i for i, k in enumerate(tc.layer_kinds()) if k == CROSS]
    assert cross == [4]
    for i in cross:
        assert set(tcache[i]) == {"k", "v"}
        assert tcache[i]["k"].shape == (2, tc.num_image_tokens,
                                        tc.num_kv_heads, tc.resolved_head_dim)
        k, v = tattn.cross_kv(tp.layers[i].attn, _t(enc), tc)
        assert torch.equal(tcache[i]["k"], k) and torch.equal(
            tcache[i]["v"], v)
    before = [tcache[i]["k"].clone() for i in cross]
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1)[:, None]
    jtoks, ttoks = [], []
    for i in range(8):
        jl, jcache = jdecode(jp, jcache, jt, prompt.shape[1] + i)
        tl, tcache = TM.decode_step(tp, tcache, tt, prompt.shape[1] + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        jtoks.append(np.asarray(jt[:, 0]).tolist())
        ttoks.append(tt[:, 0].tolist())
    assert ttoks == jtoks
    for i, b in zip(cross, before):
        assert torch.equal(tcache[i]["k"], b)


@pytest.mark.parametrize("dt,hq,hkv,t", [("f32", 4, 2, 9), ("f32", 8, 1, 130),
                                         ("bf16", 4, 2, 9),
                                         ("bf16", 64, 8, 1601)])
def test_cross_decode_plain_route_matches_noncausal_reference(dt, hq, hkv, t):
    """The cross decode's plain route, ``decode_attention_plain`` with
    ``pos=None`` and ``cache_len = T`` on every lane, against JAX's
    non-causal ``ref.mha_reference`` (what the reference's one-query flash
    call computes): f32 within 1e-5, bf16 within 2^-7 x max(1, |ref|)
    (the last case at llama-3.2-vision's heads over 1601 image tokens)."""
    rng = np.random.default_rng(t)
    d, b = 128 if t == 1601 else 16, 3
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    scale = d ** -0.5
    exp = np.asarray(jref.mha_reference(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=False, window=0,
        scale=scale).astype(jnp.float32))
    got = dk.decode_attention_plain(
        *(_t(a).to(tdt) for a in (q, k, v)),
        cache_len=torch.full((b,), t, dtype=torch.int32), pos=None,
        scale=scale).float().numpy()
    lim = 1e-5 if dt == "f32" else 2.0 ** -7 * max(1.0, np.abs(exp).max())
    assert np.abs(got - exp).max() <= lim


def test_bridge_takes_cross_layers_from_their_period_slot():
    """At 10 layers (two periods, no tail) each layer's leaves, cross ones
    included, are the period slot's at that repeat; the stack then gives
    JAX's logits."""
    jc, tc = _cfgs(num_layers=10)
    assert (tc.num_periods, tc.num_tail_layers) == (2, 0)
    jp = JM.init_model(jax.random.PRNGKey(4), jc)
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(tree, tc, "cpu")
    assert [layer.kind for layer in tp.layers] == list(tc.layer_kinds())
    for i, layer in enumerate(tp.layers):
        r, slot = divmod(i, 5)
        src = tree["periods"][slot]["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            assert np.array_equal(layer.attn[name].numpy(), src[name][r])
    toks = _prompt(9, tc.vocab_size, 6)[None]
    enc = _enc(1, tc, 7)
    jl, _ = JM.forward(jp, jnp.asarray(toks), jc, enc=jnp.asarray(enc))
    tl, _ = TM.forward(tp, _t(toks).long(), tc, enc=_t(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_cross_stack_without_enc_raises(stack):
    jc, jp, tc, tp = stack
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="cross-attention.*enc"):
        TM.forward(tp, toks, tc)
    with pytest.raises(ValueError, match="cross-attention.*enc"):
        TM.prefill(tp, toks, tc, 16)
    cache = TM.init_cache(tc, 1, 16, "cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        TM.prefill_chunk(tp, cache, toks, 0, tc)
    assert TM.chunked_prefill_caps(tc, 16)["kinds"]["cross"] is False


def test_replica_and_serve_cli_refuse_a_cross_stack(stack, capsys):
    """The reference engine cannot build a replica of this stack (it
    prefills without ``enc``); the port's replica refuses it before
    warming up, saying why, and so does the serve CLI, before drawing any
    weight.  Paged mode keeps its own refusal."""
    jc, jp, tc, tp = stack
    with pytest.raises(ValueError):
        jeng.Replica("jax", jc, jp, slots=1, capacity=32)
    with pytest.raises(ValueError, match="encoder states.*engine.py:444"):
        teng.Replica("torch", tc, tp, slots=1, capacity=32)
    with pytest.raises(ValueError, match="paged KV requires chunked"):
        teng.Replica("torch", tc, tp, slots=1, capacity=32, paged=True)
    with pytest.raises(ValueError, match="encoder states"):
        tserve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2"])
    assert "warmup" not in capsys.readouterr().out


def test_published_cross_config():
    cfg = get_config(ARCH)
    kinds = cfg.layer_kinds()
    assert cfg.pattern_period == 5 and kinds[:5] == ("attn",) * 4 + ("cross",)
    assert kinds.count("cross") == 20 and cfg.num_image_tokens == 1601
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (64, 8, 128)

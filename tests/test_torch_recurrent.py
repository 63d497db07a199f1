"""The port's recurrent stacks (Mamba2 SSD and Griffin RG-LRU) against the
JAX package's on the CPU, on the same numpy inputs: the ported oracles
against ``repro.kernels.ref``; the SSD and RG-LRU plain versions against
the Pallas kernels in interpret mode; the mixers' full-sequence, prefill-
chunk and decode functions on bridged weights, in f32 and in bf16; the
chunked-prefill state threading of both smoke models; and greedy streams
of the port's ``Replica`` against the JAX ``Replica``, with mid-stream
joins.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against the plain version tested here.

Tolerances:

* f32: 1e-5 absolute plus 1e-5 relative.  Both sides compute the same f32
  math in another order; the SSD's cumulative log-decay (|cum| up to ~10
  here) is summed in another order (XLA's reduce-window against torch's
  cumsum) and enters ``exp``, which puts a relative error of a few 1e-7 on
  outputs of several units.
* bf16 oracles and scans: both round the same f32 result once, so one
  bf16 step of the largest |reference| (2^-7 relative to it).
* bf16 blocks: the outputs pass through bf16 element-wise chains that the
  two frameworks round at other places (silu, gelu, the gated norm), so
  2^-6 of the largest |reference|.  The recurrent states are float32: the
  RG-LRU ``h`` comes out of the same bf16 conv outputs through the same
  f32 gate math, so 1e-5 relative; the SSD ``state`` sums products of bf16
  inputs that can differ by one bf16 step (silu rounded once here, twice
  there), so 2^-7 relative.  Storing the leaves the reference reads in
  float32 in bf16 instead moves the RG-LRU ``h`` by 0.25-0.5% at these
  seeds, which its bound catches; it moves the SSD ``state`` by 0.5%, the
  order of that bf16 noise (0.4%), so the storage types themselves are
  pinned by ``test_recurrent_init_distributions_and_f32_leaves``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru as pallas_rglru
from repro.kernels.ssd_scan import ssd as pallas_ssd
from repro.models import model as JM
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.serving import engine as jeng
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as gk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import model as TM
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.serving import engine as teng

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = 1e-4


def _j(a, dt="f32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dt])


def _t(a, dt="f32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dt])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, exp, dt, rel=None):
    """f32: 1e-5 absolute + 1e-5 relative; bf16 (or ``rel``): ``rel`` of
    the largest |reference| (2^-7 by default)."""
    got, exp = _np(got), _np(exp)
    assert got.shape == exp.shape
    if dt == "f32" and rel is None:
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)
        return
    lim = (rel or 2.0 ** -7) * max(1.0, float(np.abs(exp).max()))
    assert float(np.abs(got - exp).max()) <= lim


# ----------------------------------------------------------------- oracles
def _ssd_inputs(rng, b=2, s=32, h=3, p=16, n=8):
    """x, dt (post-softplus, around the reference's dt init), a_log, B, C,
    d_skip as numpy arrays."""
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), h))
    bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((b, s, h)) + bias))
    return (rng.standard_normal((b, s, h, p)), dt,
            np.log(rng.uniform(1.0, 16.0, h)), rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n)), rng.standard_normal(h))


def _rglru_inputs(rng, b=2, s=37, d=40):
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, d)) / 8.0))
    r = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    gate = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    return (rng.standard_normal((b, s, d)), -8.0 * np.log1p(np.exp(lam)) * r,
            gate)


def _oracle_args(name, rng):
    """(args, keyword args, which args are float32 regardless of dt)."""
    if name == "segsum":
        return (-np.abs(rng.standard_normal((2, 3, 24))),), {}, ()
    if name in ("ssd_reference", "ssd_chunked"):
        x, dt, a_log, bm, cm, ds = _ssd_inputs(rng)
        kw = {"chunk": 8} if name == "ssd_chunked" else {}
        return (x, dt, a_log, bm, cm, ds), kw, (2, 5)
    if name == "ssd_decode_step":
        h = rng.standard_normal((2, 3, 8, 16))
        x, dt, a_log, bm, cm, ds = _ssd_inputs(rng, s=1)
        return (h, x[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0], ds), {}, \
            (0, 3, 6)
    if name in ("rglru_reference", "rglru_chunked"):
        return _rglru_inputs(rng), {}, ()
    if name == "rglru_decode_step":
        x, la, g = _rglru_inputs(rng, s=1)
        return (rng.standard_normal((2, 40)), x[:, 0], la[:, 0], g[:, 0]), \
            {}, (0,)
    if name == "causal_conv1d":
        return (rng.standard_normal((2, 11, 40)), rng.standard_normal((4, 40)),
                rng.standard_normal(40)), {}, (1, 2)
    assert name == "causal_conv1d_step"
    return (rng.standard_normal((2, 3, 40)), rng.standard_normal((2, 40)),
            rng.standard_normal((4, 40)), rng.standard_normal(40)), {}, (2, 3)


@pytest.mark.parametrize("name,dt", [
    ("segsum", "f32"),
    *[(n, dt) for n in ("ssd_reference", "ssd_chunked", "ssd_decode_step",
                        "rglru_reference", "rglru_chunked",
                        "rglru_decode_step", "causal_conv1d",
                        "causal_conv1d_step")
      for dt in ("f32", "bf16")]])
def test_oracles_match_jax(name, dt):
    """Every ported SSD / RG-LRU / conv oracle against
    ``repro.kernels.ref`` on the same inputs (f32 leaves stay f32, as the
    model passes them)."""
    args, kw, f32_args = _oracle_args(name, np.random.default_rng(1))
    jargs = [_j(a, "f32" if i in f32_args else dt) for i, a in enumerate(args)]
    targs = [_t(a, "f32" if i in f32_args else dt) for i, a in enumerate(args)]
    jout = jax.jit(lambda *a: getattr(jref, name)(*a, **kw))(*jargs)
    tout = getattr(tref, name)(*targs, **kw)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for got, exp in zip(tout, jout):
        if name == "segsum":
            mask = np.isfinite(_np(exp))
            np.testing.assert_array_equal(np.isfinite(_np(got)), mask)
            np.testing.assert_allclose(_np(got)[mask], _np(exp)[mask],
                                       atol=1e-5, rtol=1e-5)
        else:
            _close(got, exp, dt)


# ----------------------------------------------------- plain vs Pallas
@pytest.mark.parametrize("b,s,chunk,skip,dt", [
    (1, 64, 16, True, "f32"),
    (2, 64, 32, False, "f32"),
    (2, 48, 12, True, "f32"),      # a chunk that is not a power of two
    (2, 32, 16, False, "bf16"),
])
def test_ssd_plain_matches_pallas_interpret(b, s, chunk, skip, dt):
    """``ssd_plain`` (the CPU path and the kernel's oracle) against the TPU
    kernel run in interpret mode.  bf16 without ``d_skip``: the TPU kernel
    adds ``d_skip x`` after rounding y to bf16, the reference (and the
    port) before."""
    x, dtv, a_log, bm, cm, ds = _ssd_inputs(np.random.default_rng(2), b=b,
                                            s=s, h=2, p=16, n=8)
    ds = ds if skip else None
    jout = pallas_ssd(_j(x, dt), _j(dtv, dt), _j(a_log), _j(bm, dt),
                      _j(cm, dt), None if ds is None else _j(ds), chunk=chunk,
                      interpret=True)
    tout = sk.ssd_plain(_t(x, dt), _t(dtv, dt), _t(a_log), _t(bm, dt),
                        _t(cm, dt), None if ds is None else _t(ds),
                        chunk=chunk)
    assert tout.dtype == TDT[dt]
    _close(tout, jout, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rglru_plain_matches_pallas_interpret(dt):
    """``rglru_plain`` against the TPU kernel in interpret mode, with a
    sequence (37) that is not a multiple of its chunk (16) and a width (40)
    that is not a multiple of its block (16)."""
    args = _rglru_inputs(np.random.default_rng(3))
    jout = pallas_rglru(*[_j(a, dt) for a in args], chunk=16, block_d=16,
                        interpret=True)
    tout = gk.rglru_plain(*[_t(a, dt) for a in args])
    assert tout.dtype == TDT[dt]
    _close(tout, jout, dt)


def test_scan_wrappers_refuse_cpu_and_plain_calls_are_not_counted():
    """``ops`` routes CPU tensors to the plain versions, which leave the
    launch counters alone; the kernel wrappers refuse CPU tensors."""
    rng = np.random.default_rng(4)
    x, dtv, a_log, bm, cm, ds = [_t(a) for a in _ssd_inputs(rng)]
    gx, gla, gg = [_t(a) for a in _rglru_inputs(rng)]
    ops.reset_kernel_launches()
    ops.ssd(x, dtv, a_log, bm, cm, ds, chunk=8)
    ops.rglru(gx, gla, gg)
    assert ops.kernel_launches()["ssd"] == 0
    assert ops.kernel_launches()["rglru"] == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        sk.ssd(x, dtv, a_log, bm, cm, ds, chunk=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.rglru(gx, gla, gg)


# ------------------------------------------------------------------ blocks
def _mixer(arch, dt, key):
    """(jax cfg, jax layer-0 mixer params, port cfg, port mixer params, the
    port model) on identical weights; f32 masters on the JAX side."""
    jc = jget_smoke(arch).replace(dtype=JDT[dt], param_dtype=jnp.float32)
    tc = get_smoke_config(arch).replace(dtype=TDT[dt])
    tree = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(3), jc))
    tp = bridge.params_from_numpy(tree, tc, "cpu")
    jpar = jax.tree.map(jnp.asarray, bridge._layer_tree(tree, jc, 0)[key])
    return jc, jpar, tc, getattr(tp.layers[0], key), tp


@pytest.mark.parametrize("arch,dt", [("mamba2-780m", "f32"),
                                     ("mamba2-780m", "bf16"),
                                     ("recurrentgemma-9b", "f32"),
                                     ("recurrentgemma-9b", "bf16")])
def test_mixers_match_jax(arch, dt):
    """``ssm_mixer``/``ssm_prefill_chunk``/``ssm_decode`` (Mamba2) and
    ``rglru_block``/``rglru_prefill_chunk``/``rglru_decode`` (Griffin) on
    bridged weights: outputs and every cache leaf, over a 24-token
    sequence, three 8-token chunks threading the state, and three decode
    steps after them."""
    ssm = arch.startswith("mamba2")
    key = "ssm" if ssm else "rec"
    jlib, tlib = (JS, TS) if ssm else (JR, TR)
    state = "state" if ssm else "h"
    jc, jpar, tc, tpar, _ = _mixer(arch, dt, key)
    x = np.random.default_rng(5).standard_normal((2, 24, jc.d_model))
    jx, tx = _j(x, dt), _t(x, dt)
    out_rel = None if dt == "f32" else 2.0 ** -6
    state_rel = None if dt == "f32" else (2.0 ** -7 if ssm else 1e-5)
    # bf16 runs op by op: under jit XLA keeps element-wise chains in f32
    # (excess precision), further from PyTorch's eager rounding points
    jit = jax.jit if dt == "f32" else (lambda fn: fn)

    def check(ty, jy, tcache, jcache):
        _close(ty, jy, dt, out_rel)
        _close(tcache["conv"], jcache["conv"], dt)
        assert tcache[state].dtype == torch.float32
        _close(tcache[state], jcache[state], dt, state_rel)

    full = (JS.ssm_mixer if ssm else JR.rglru_block)
    tfull = (TS.ssm_mixer if ssm else TR.rglru_block)
    ty, tst = tfull(tpar, tx, tc, return_state=True)
    jy, jst = jit(lambda p, v: full(p, v, jc, return_state=True))(jpar, jx)
    check(ty, jy, tst, jst)

    init = TS.init_ssm_cache if ssm else TR.init_rglru_cache
    jinit = JS.init_ssm_cache if ssm else JR.init_rglru_cache
    tcache, jcache = init(tc, 2, "cpu"), jinit(jc, 2)
    chunk_fn = "ssm_prefill_chunk" if ssm else "rglru_prefill_chunk"
    jchunk = jit(lambda p, v, c: getattr(jlib, chunk_fn)(p, v, c, jc))
    for c0 in range(0, 24, 8):
        ty, tcache = getattr(tlib, chunk_fn)(tpar, tx[:, c0:c0 + 8], tcache,
                                             tc)
        jy, jcache = jchunk(jpar, jx[:, c0:c0 + 8], jcache)
        check(ty, jy, tcache, jcache)
    dec_fn = "ssm_decode" if ssm else "rglru_decode"
    jdec = jit(lambda p, v, c: getattr(jlib, dec_fn)(p, v, c, jc))
    for i in range(3):
        ty, tcache = getattr(tlib, dec_fn)(tpar, tx[:, i:i + 1], tcache, tc)
        jy, jcache = jdec(jpar, jx[:, i:i + 1], jcache)
        check(ty, jy, tcache, jcache)


# the leaves the reference reads in float32 (``.astype(f32)`` of an f32
# master, never cast to the compute dtype)
F32_LEAVES = {"ssm": {"conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
                      "norm"},
              "rec": {"conv_w", "conv_b", "b_a", "b_i", "lam"}}


def test_recurrent_init_distributions_and_f32_leaves():
    """``init_model`` draws the reference's recurrent initializers, and the
    leaves the reference reads in float32 are stored in float32 in a bf16
    model (the projections in bf16)."""
    for arch, key in (("mamba2-780m", "ssm"), ("recurrentgemma-9b", "rec")):
        cfg = get_smoke_config(arch).replace(d_model=256)
        m = TM.init_model(cfg, 0, "cpu")
        for layer in m.layers:
            p = getattr(layer, key)
            if p is None:
                continue
            for name, t in p.items():
                want = torch.float32 if name in F32_LEAVES[key] else cfg.dtype
                assert t.dtype == want, (arch, name)
            assert float(p["conv_b"].abs().max()) == 0.0
        p = m.layers[0].ssm if key == "ssm" else m.layers[0].rec
        if key == "ssm":
            assert torch.equal(p["d_skip"], torch.ones_like(p["d_skip"]))
            a = torch.exp(p["a_log"])
            assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
            dt = torch.nn.functional.softplus(p["dt_bias"])
            assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
            assert float(dt.max()) <= 0.1 * (1 + 1e-4)
            assert float(p["norm"].abs().max()) == 0.0
        else:
            a = torch.exp(-cfg.rglru_c * torch.nn.functional.softplus(p["lam"]))
            assert abs(float(a[0]) - 0.9) < 1e-5
            assert abs(float(a[-1]) - 0.999) < 1e-5
            assert float(p["b_a"].abs().max()) == float(p["b_i"].abs().max()) \
                == 0.0


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module")
def stacks():
    """arch -> (jax cfg, jax params, port cfg, port model), f32."""
    torch.set_num_threads(2)
    out = {}
    for arch in ("mamba2-780m", "recurrentgemma-9b"):
        jc = jget_smoke(arch).replace(dtype=jnp.float32,
                                      param_dtype=jnp.float32)
        tc = get_smoke_config(arch).replace(dtype=torch.float32)
        jp = JM.init_model(jax.random.PRNGKey(0), jc)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
        out[arch] = (jc, jp, tc, tp)
    return out


def _jax_layers(cache, cfg):
    """The JAX cache pytree as the port's per-layer list of numpy dicts."""
    out = []
    for i in range(cfg.num_layers):
        if i < cfg.num_periods * cfg.pattern_period:
            r, slot = divmod(i, cfg.pattern_period)
            out.append({k: np.asarray(v)[r]
                        for k, v in cache["periods"][slot].items()})
        else:
            out.append({k: np.asarray(v) for k, v in cache["tail"][
                i - cfg.num_periods * cfg.pattern_period].items()})
    return out


def _caches_close(tcache, jcache, jc, atol=LOGIT_TOL):
    for tl, jl in zip(tcache, _jax_layers(jcache, jc)):
        assert sorted(tl) == sorted(jl)
        for name, leaf in jl.items():
            if name == "pos":
                np.testing.assert_array_equal(tl[name].numpy(), leaf)
            else:
                np.testing.assert_allclose(tl[name].float().numpy(), leaf,
                                           atol=atol, rtol=atol)


@pytest.mark.parametrize("arch,plen,chunk", [
    ("mamba2-780m", 37, 8),
    ("recurrentgemma-9b", 28, 5),     # the 16-wide local ring wraps
])
def test_chunked_prefill_threads_state_like_jax(stacks, arch, plen, chunk):
    """Chunk after chunk, the port's every cache leaf (conv tails, SSD
    states, RG-LRU hidden states, attention rings) equals JAX's, and the
    final caches equal the whole-prompt prefill's: decode continues from
    either with the same logits."""
    jc, jp, tc, tp = stacks[arch]
    cap = 32
    prompt = np.random.default_rng(6).integers(
        2, tc.vocab_size, size=plen).astype(np.int32)
    cache, jcache = TM.init_cache(tc, 1, cap, "cpu"), JM.init_cache(jc, 1, cap)
    jchunk = jax.jit(lambda p, c, t, s: JM.prefill_chunk(p, c, t, s, jc))
    for c0 in range(0, plen, chunk):
        piece = prompt[c0:c0 + chunk]
        tl, cache = TM.prefill_chunk(tp, cache, torch.from_numpy(piece).long()
                                     [None], c0, tc)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(piece)[None], c0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        _caches_close(cache, jcache, jc)
    lw, whole = TM.prefill(tp, torch.from_numpy(prompt).long()[None], tc, cap)
    assert float((lw - tl).abs().max()) < LOGIT_TOL
    for a, b in zip(cache, whole):
        for name in a:
            assert torch.allclose(a[name].float(), b[name].float(),
                                  atol=LOGIT_TOL, rtol=LOGIT_TOL), name
    tok = torch.argmax(tl[:, -1], -1)[:, None]
    l1, _ = TM.decode_step(tp, cache, tok, plen, tc)
    l2, _ = TM.decode_step(tp, whole, tok, plen, tc)
    assert float((l1 - l2).abs().max()) < LOGIT_TOL


# ------------------------------------------------------------------ engine
def _staggered(gen, reqs, gap_s=0.03):
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


@pytest.mark.parametrize("arch,capacity", [("mamba2-780m", 64),
                                           ("recurrentgemma-9b", 32)])
def test_replica_streams_match_jax_replica(stacks, arch, capacity):
    """Four greedy requests on two lanes, joining while others decode:
    the port's streams equal the JAX replica's (recurrentgemma's 28-token
    prompt wraps its 16-slot local ring), and its ``generate_sequential``
    (whole-prompt prefill) agrees."""
    jc, jp, tc, tp = stacks[arch]
    kw = dict(slots=2, capacity=capacity, prefill_chunk_tokens=8)
    jrep = jeng.Replica("jax", jc, jp, **kw)
    trep = teng.Replica("torch", tc, tp, **kw)
    try:
        rng = np.random.default_rng(7)
        prompts = [rng.integers(2, tc.vocab_size, size=n).astype(np.int32)
                   for n in (11, 28, 6, 19)]
        new = [8, 3, 9, 5]
        got = _staggered(trep.generate, [teng.Request(i, p, n, 1e9) for i, (p, n)
                                         in enumerate(zip(prompts, new))])
        exp = _staggered(jrep.generate, [jeng.Request(i, p, n, 1e9) for i, (p, n)
                                         in enumerate(zip(prompts, new))])
        assert got == exp
        for i, (p, n) in enumerate(zip(prompts, new)):
            assert trep.generate_sequential(
                teng.Request(10 + i, p, n, 1e9)).tolist() == got[i]
        assert trep.prefill_chunks > 0 and trep.decode_steps > 0
    finally:
        jrep.stop()
        trep.stop()


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_serve_cli_recurrent_archs_on_cpu(arch, capsys):
    """The serve CLI serves both recurrent archs on the CPU, ring and
    paged, every request ``ok``; ``--prefix-cache`` is refused."""
    from repro_torch.launch import serve as tserve
    base = ["--device", "cpu", "--arch", arch, "--requests", "3",
            "--interval-ms", "1", "--new-tokens", "4", "--prompt-len", "20"]
    for extra in ([], ["--paged"]):
        tserve.main(base + extra)
        assert "outcomes: ok=3 rejected=0 shed=0 lost=0" in \
            capsys.readouterr().out
    with pytest.raises(ValueError, match="prefix_cache"):
        tserve.main(base + ["--prefix-cache"])

"""The port's split-S flash-decode over a serving mesh against the JAX
package's on the CPU.

* ``spmd_decode_attention`` on a (2, 4) mesh of CPU devices against JAX's
  ``ref.decode_mha_masked`` over the whole cache: the cases of
  ``tests/test_distributed.py`` (a scalar index with a shared (S,) pos, a
  per-lane index with per-lane pos, windows 0 and 8; at S 32 a shard holds
  8 slots, so the window of a lane at 20 ends inside shard 1), f32 within
  1e-5, the written caches and pos exact; one bf16 case within 2^-7 of
  max(1, max|ref|).
* One subprocess with eight fake JAX devices runs JAX's own
  ``spmd_decode_attention`` and ``spmd_paged_decode_attention`` on the
  same inputs; the port's functions match both, an empty paged lane
  (zeros, where the paged oracle gives the mean of V) included.
* The plain partials (``ref.local_attend``, split as the kernels split)
  and the combine (``ref.combine_partials``) against the JAX formulas.
* ``model.decode_step`` under a (2, 4) mesh against JAX's single-device
  ``decode_step`` (granite-8b smoke, f32, B 4, idx [0, 3, 7, 12]): logits
  within 1e-4, caches within 1e-5 through ``gather_cache``.
* ``make_mesh`` and the cache layout (``shard_cache`` / ``gather_cache``
  round trip, the paged pool's scratch rows).

The partials and combine kernels run only on the card: ``chip_smoke.py``
(phase 2m) holds them against the plain versions tested here.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.serving.spmd_decode import _local_attend as jlocal_attend
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pk
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.serving import spmd_decode as spmd
from repro_torch.sharding import context as shctx
from repro_torch.sharding.mesh import Mesh, make_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S, HQ, HKV, D = 4, 32, 8, 2, 16
SCALE = D ** -0.5
PAGE, MAXP, PROWS = 4, 6, 16          # pool rows (the dump row included)
F32_TOL = 1e-5


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _ring_inputs(seed, per_lane, dtype=np.float32):
    """q, caches, new K/V, pos and the index of the JAX test's cases: a
    per-lane index [5, 20, 31, 0] with per-lane pos, or scalar 20 with a
    shared (S,) pos; positions below each lane's index are in the ring."""
    rng = np.random.default_rng(seed)
    t = {n: rng.standard_normal(sh).astype(dtype) for n, sh in (
        ("q", (B, 1, HQ, D)), ("k", (B, S, HKV, D)), ("v", (B, S, HKV, D)),
        ("nk", (B, 1, HKV, D)), ("nv", (B, 1, HKV, D)))}
    ar = np.arange(S)
    if per_lane:
        t["idx"] = np.asarray([5, 20, 31, 0], np.int32)
        t["pos"] = np.where(ar[None] < t["idx"][:, None], ar[None],
                            -1).astype(np.int32)
    else:
        t["idx"] = np.asarray(20, np.int32)
        t["pos"] = np.where(ar < 20, ar, -1).astype(np.int32)
    return t


def _paged_inputs(seed):
    """Pools of 16 rows of 4-slot pages (15 pages and the dump row) and 4
    lanes at positions [13, 9, 0, 20]: lanes 0 and 1 share their first
    page, lane 2 has no page (an empty lane: it writes to the dump row),
    lane 3's second page is absent and one of its pages holds another
    position's pos (stale).  Pages come from a shuffled pool, so every
    lane's pages spread over the four shards of 4 rows."""
    rng = np.random.default_rng(seed)
    t = {n: rng.standard_normal(sh).astype(np.float32) for n, sh in (
        ("q", (B, 1, HQ, D)), ("k", (PROWS, PAGE, HKV, D)),
        ("v", (PROWS, PAGE, HKV, D)), ("nk", (B, 1, HKV, D)),
        ("nv", (B, 1, HKV, D)))}
    idx = np.asarray([13, 9, 0, 20], np.int32)
    free = iter(rng.permutation(PROWS - 1))
    tables = np.full((B, MAXP), -1, np.int32)
    pos = np.full((PROWS, PAGE), -1, np.int32)
    for b in (0, 1, 3):
        for j in range(idx[b] // PAGE + 1):
            if b == 1 and j == 0:
                tables[1, 0] = tables[0, 0]
                continue
            row = next(free)
            tables[b, j] = row
            p = j * PAGE + np.arange(PAGE)
            pos[row] = np.where(p < idx[b], p, -1)
    tables[3, 1] = -1
    pos[tables[3, 3]] = 3 * PAGE + 1 + np.arange(PAGE)   # stale entries
    entry = tables[np.arange(B), np.minimum(idx // PAGE, MAXP - 1)]
    t.update(idx=idx, tables=tables, pos=pos,
             rows=np.where(entry >= 0, entry, PROWS - 1).astype(np.int32),
             within=(idx % PAGE).astype(np.int32))
    return t


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_ring(t, window, mesh=None, dtype=torch.float32):
    out, kc, vc, pc = spmd.spmd_decode_attention(
        mesh or _mesh(), _t(t["q"]).to(dtype), _t(t["k"]).to(dtype),
        _t(t["v"]).to(dtype), _t(t["nk"]).to(dtype), _t(t["nv"]).to(dtype),
        _t(t["pos"]), _t(t["idx"]), window=window, scale=SCALE)
    return out, kc.gather(), vc.gather(), pc.gather()


def _port_paged(t, window, softcap=0.0):
    out, kp, vp, pp = spmd.spmd_paged_decode_attention(
        _mesh(), _t(t["q"]), _t(t["k"]), _t(t["v"]), _t(t["pos"]),
        _t(t["tables"]), _t(t["nk"]), _t(t["nv"]), _t(t["rows"]).long(),
        _t(t["within"]).long(), _t(t["idx"]), window=window, scale=SCALE,
        softcap=softcap)
    return out, kp.gather(), vp.gather(), pp.gather()


def _ring_written(t):
    """The unsharded write: each lane's new K/V and position at its
    slot."""
    idx = np.broadcast_to(t["idx"], (B,))
    slots = idx % S
    k, v, pos = t["k"].copy(), t["v"].copy(), t["pos"].copy()
    k[np.arange(B), slots] = t["nk"][:, 0]
    v[np.arange(B), slots] = t["nv"][:, 0]
    if pos.ndim == 2:
        pos[np.arange(B), slots] = idx
    else:
        pos[slots[0]] = idx[0]
    return k, v, pos


# -------------------------------------------------------- against the oracle
@pytest.mark.parametrize("per_lane,window", [(False, 0), (False, 8),
                                             (True, 0), (True, 8)])
def test_spmd_decode_matches_reference(per_lane, window):
    """The JAX test's cases: the port's sharded step against
    ``ref.decode_mha_masked`` over the whole written cache (JAX); the
    written caches and pos equal the unsharded write."""
    t = _ring_inputs(3 + per_lane + window, per_lane)
    out, kc, vc, pc = _port_ring(t, window)
    k, v, pos = _ring_written(t)
    hi = t["idx"][:, None] if per_lane else t["idx"]
    valid = pos >= 0
    if window:
        valid &= pos > hi - window
    exp = jref.decode_mha_masked(jnp.asarray(t["q"]), jnp.asarray(k),
                                 jnp.asarray(v), valid_mask=jnp.asarray(valid),
                                 scale=SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=F32_TOL,
                               rtol=0)
    assert np.array_equal(kc.numpy(), k) and np.array_equal(vc.numpy(), v)
    assert np.array_equal(pc.numpy(), pos)


def test_spmd_decode_bf16_matches_reference():
    """bf16 caches: the sharded step within 2^-7 of max(1, max|ref|) of
    JAX's oracle on the same bf16 values; the write exact."""
    t = _ring_inputs(11, True)
    out, kc, vc, pc = _port_ring(t, 8, dtype=torch.bfloat16)
    bf = {n: _t(t[n]).to(torch.bfloat16).float().numpy()
          for n in ("q", "k", "v", "nk", "nv")}
    k, v, pos = _ring_written(dict(t, **bf))
    valid = (pos >= 0) & (pos > t["idx"][:, None] - 8)
    exp = np.asarray(jref.decode_mha_masked(
        jnp.asarray(bf["q"], jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), valid_mask=jnp.asarray(valid),
        scale=SCALE).astype(jnp.float32))
    tol = 2.0 ** -7 * max(1.0, float(np.abs(exp).max()))
    assert float(np.abs(out.float().numpy() - exp).max()) <= tol
    assert np.array_equal(kc.float().numpy(), k)
    assert np.array_equal(pc.numpy(), pos)


def test_per_lane_index_needs_per_lane_pos():
    t = _ring_inputs(0, False)
    with pytest.raises(ValueError, match="per-lane"):
        spmd.spmd_decode_attention(
            _mesh(), _t(t["q"]), _t(t["k"]), _t(t["v"]), _t(t["nk"]),
            _t(t["nv"]), _t(t["pos"]), torch.tensor([1, 2, 3, 4]),
            scale=SCALE)


# ------------------------------------------------- against JAX's own spmd
JAX_SPMD = """
import numpy as np, jax, jax.numpy as jnp
from repro.serving.spmd_decode import (spmd_decode_attention,
                                       spmd_paged_decode_attention)
mesh = jax.make_mesh((2, 4), ("data", "model"))
inp = np.load({inp!r})
out = {{}}
for case in {ring_cases!r}:
    w = int(case.split("_w")[1])
    g = lambda n: jnp.asarray(inp[case.split("_w")[0] + "_" + n])
    o, k, v, p = jax.jit(lambda *a: spmd_decode_attention(
        mesh, *a, window=w, scale={scale!r}))(
        g("q"), g("k"), g("v"), g("nk"), g("nv"), g("pos"), g("idx"))
    out.update({{case + "_out": o, case + "_k": k, case + "_pos": p}})
for case in {paged_cases!r}:
    w, cap = (int(x) for x in case.split("_")[1:])
    g = lambda n: jnp.asarray(inp["paged_" + n])
    o, k, v, p = jax.jit(lambda *a: spmd_paged_decode_attention(
        mesh, *a, window=w, scale={scale!r}, softcap=float(cap)))(
        g("q"), g("k"), g("v"), g("pos"), g("tables"), g("nk"), g("nv"),
        g("rows"), g("within"), g("idx"))
    out.update({{case + "_out": o, case + "_k": k, case + "_pos": p}})
np.savez({res!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""
RING_CASES = ["scalar_w0", "scalar_w8", "lanes_w0", "lanes_w8"]
PAGED_CASES = ["paged_0_0", "paged_8_0", "paged_0_30"]


@pytest.fixture(scope="module")
def jax_spmd(tmp_path_factory):
    """JAX's spmd functions on eight fake host devices, in a subprocess,
    over the inputs of ``_ring_inputs`` and ``_paged_inputs``."""
    d = tmp_path_factory.mktemp("spmd")
    inp = {}
    for name, per_lane in (("scalar", False), ("lanes", True)):
        for n, a in _ring_inputs(7, per_lane).items():
            inp[f"{name}_{n}"] = a
    for n, a in _paged_inputs(5).items():
        inp[f"paged_{n}"] = a
    np.savez(d / "in.npz", **inp)
    code = JAX_SPMD.format(inp=str(d / "in.npz"), res=str(d / "out.npz"),
                           ring_cases=RING_CASES, paged_cases=PAGED_CASES,
                           scale=SCALE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.setdefault("REPRO_KERNEL_IMPL", "jnp")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_matches_jax_spmd(jax_spmd, case):
    name, w = case.split("_w")
    t = _ring_inputs(7, name == "lanes")
    out, kc, _, pc = _port_ring(t, int(w))
    np.testing.assert_allclose(out.numpy(), jax_spmd[case + "_out"],
                               atol=F32_TOL, rtol=0)
    assert np.array_equal(kc.numpy(), jax_spmd[case + "_k"])
    assert np.array_equal(pc.numpy(), jax_spmd[case + "_pos"])


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_matches_jax_spmd(jax_spmd, case):
    """Paged, window 0 and 8 and a softcap: outputs (lane 2, empty, is
    zeros in both), the written pools and pos equal JAX's."""
    w, cap = (int(x) for x in case.split("_")[1:])
    t = _paged_inputs(5)
    out, kp, _, pp = _port_paged(t, w, cap)
    np.testing.assert_allclose(out.numpy(), jax_spmd[case + "_out"],
                               atol=F32_TOL, rtol=0)
    assert not out[2].any()
    assert np.array_equal(kp.numpy(), jax_spmd[case + "_k"])
    assert np.array_equal(pp.numpy(), jax_spmd[case + "_pos"])


def test_paged_matches_oracle_on_live_lanes():
    """Against the paged oracle on the written pools: equal on every lane
    with a visible slot; the empty lane gets zeros (the spmd semantics),
    where the oracle gives the mean of V."""
    t = _paged_inputs(9)
    out, kp, vp, pp = _port_paged(t, 0)
    exp = tref.paged_decode_mha_reference(
        _t(t["q"]), kp, vp, pp, _t(t["tables"]),
        cache_len=_t(t["idx"] + 1), scale=SCALE)
    live = [0, 1, 3]
    np.testing.assert_allclose(out[live].numpy(), exp[live].numpy(),
                               atol=F32_TOL, rtol=0)
    assert not out[2].any() and exp[2].abs().max() > 0


# ----------------------------------------------------- partials and combine
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_local_attend_matches_jax(softcap):
    """``ref.local_attend`` against the reference's ``_local_attend``: (m,
    l, acc) per (lane, query head), NEG_INF and zeros for a lane with
    nothing visible."""
    t = _ring_inputs(13, True)
    valid = t["pos"] >= 0
    valid[3] = False
    m, l, acc = tref.local_attend(_t(t["q"]), _t(t["k"]), _t(t["v"]),
                                  _t(valid), SCALE, softcap)
    jm, jl, jacc = jlocal_attend(jnp.asarray(t["q"]), jnp.asarray(t["k"]),
                                 jnp.asarray(t["v"]), jnp.asarray(valid),
                                 SCALE, softcap)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(B, HQ),
                               atol=F32_TOL, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(B, HQ),
                               rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(),
                               np.asarray(jacc).reshape(B, HQ, D),
                               atol=F32_TOL, rtol=1e-5)
    assert (m[3] == tref.NEG_INF).all() and not l[3].any()


def test_combine_matches_jax_formula():
    """``ref.combine_partials`` against the reference's pmax/psum combine
    written in jnp, with empty states among the shards and one row empty
    on every shard (zeros)."""
    rng = np.random.default_rng(17)
    rows, shards = 6, 5
    m = rng.standard_normal((rows, shards)).astype(np.float32) * 3
    l = rng.random((rows, shards)).astype(np.float32) * 4
    acc = rng.standard_normal((rows, shards, D)).astype(np.float32)
    m[1, :2], l[1, :2], acc[1, :2] = -1e30, 0.0, 0.0
    m[4], l[4], acc[4] = -1e30, 0.0, 0.0
    jm, jl, ja = jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc)
    m_g = jm.max(axis=1, keepdims=True)
    corr = jnp.exp(jm - m_g)
    exp = (ja * corr[..., None]).sum(1) / jnp.maximum(
        (jl * corr).sum(1), 1e-30)[:, None]
    got = tref.combine_partials(torch.from_numpy(np.stack([m, l], -1)),
                                torch.from_numpy(acc), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=F32_TOL,
                               rtol=1e-6)
    assert not got[4].any()


@pytest.mark.parametrize("window,pos", [(0, True), (5, True), (0, False),
                                        (5, False)])
def test_split_partials_combine_to_the_oracle(window, pos):
    """The ring partials cut as the kernel cuts its splits (1, 3 and 7
    ranges), combined, equal ``decode_attention_plain``; with ``pos`` and
    without (the contiguous form).  Every lane sees its own new token (a
    lane with nothing visible is zeros here, the mean of V there)."""
    t = _ring_inputs(19, True)
    k, v, p = (_t(a) for a in _ring_written(t))
    q = _t(t["q"])
    kw = dict(cache_len=_t(t["idx"] + 1), pos=p if pos else None,
              window=window, scale=SCALE)
    exp = dk.decode_attention_plain(q, k, v, **kw)
    for splits in (1, 3, 7):
        ml, part = ops.decode_attention_partials(q, k, v, splits=splits, **kw)
        assert ml.shape == (B * HQ, splits, 2)
        assert part.shape == (B * HQ, splits, D)
        got = ops.attention_combine(ml, part, q.dtype).reshape(q.shape)
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=F32_TOL,
                                   rtol=0)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_split_partials_combine_to_the_oracle(window):
    """The paged partials in 1, 2 and 4 page-aligned splits, combined,
    equal the paged oracle on the lanes with a visible slot and give
    zeros on the empty one."""
    t = _paged_inputs(23)
    args = [_t(t[n]) for n in ("q", "k", "v", "pos", "tables")]
    kw = dict(cache_len=_t(t["idx"] + 1), window=window, scale=SCALE)
    exp = pk.paged_decode_attention_plain(*args, **kw)
    for splits in (1, 2, 4):
        ml, part = ops.paged_decode_attention_partials(*args, splits=splits,
                                                       **kw)
        got = ops.attention_combine(ml, part, torch.float32).reshape(
            exp.shape)
        np.testing.assert_allclose(got[[0, 1, 3]].numpy(),
                                   exp[[0, 1, 3]].numpy(), atol=F32_TOL,
                                   rtol=0)
        assert not got[2].any()


def test_split_ranges_cover_each_lane_once():
    """The plain split ranges (the kernels' rule) tile [lo_all, hi_all)
    without overlap at any split count."""
    cl = torch.tensor([0, 1, 7, 30, 33, 100])
    for splits in (1, 2, 5, 9):
        lo, hi = dk.split_ranges(cl, 32, True, 0, splits)
        width = (hi - lo).clamp(min=0).sum(0)
        assert torch.equal(width, cl.clamp(max=32))
        lo, hi = pk.split_ranges(cl, 8, 4, 6, splits)
        width = (hi - lo).clamp(min=0).sum(0)
        top = cl.clamp(max=32)
        assert torch.equal(width, top - torch.minimum((cl - 6).clamp(min=0),
                                                      top))


# ------------------------------------------------------- the model's step
def test_decode_step_on_mesh_matches_jax_single_device():
    """``model.decode_step`` with a per-lane index under a (2, 4) serving
    mesh against JAX's single-device ``decode_step`` on the same weights:
    logits within 1e-4, every cache leaf within 1e-5 through
    ``gather_cache``; recurrent-free granite-8b smoke, f32."""
    torch.set_num_threads(2)
    jc = jget_smoke("granite-8b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    tc = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    cap = 32
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 1))
    idx = np.asarray([0, 3, 7, 12], np.int32)
    jlg, jcache = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))(
        jp, JM.init_cache(jc, 4, cap), jnp.asarray(tok), jnp.asarray(idx))
    mesh = _mesh()
    cache = spmd.shard_cache(TM.init_cache(tc, 4, cap, "cpu"), mesh)
    with shctx.serving_mesh(mesh):
        lg, cache = TM.decode_step(tp, cache, torch.from_numpy(tok),
                                   torch.from_numpy(idx), tc)
    assert shctx.get_serving_mesh() is None
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    assert isinstance(cache[0]["k"], spmd.Sharded)
    for i, tl in enumerate(spmd.gather_cache(cache)):
        jl = bridge._layer_tree(jcache, tc, i)
        for name in tl:
            np.testing.assert_allclose(tl[name].numpy(),
                                       np.asarray(jl[name]), atol=1e-5,
                                       rtol=0)


# ------------------------------------------------------- mesh and layout
def test_make_mesh():
    m = make_mesh((2, 3), ("data", "model"), ["cpu"] * 6)
    assert isinstance(m, Mesh) and m.shape == {"data": 2, "model": 3}
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh((2, 3), ("data", "model"), ["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((1, 4), ("data", "model"))


@pytest.mark.parametrize("b", [4, 3])
def test_shard_and_gather_cache_round_trip(b):
    """Rings split lanes over ``data`` when B divides (4 lanes over 2) and
    keep one group otherwise (3); pools split rows only and keep a scratch
    row a shard; non-attention leaves pass through; ``gather_cache`` gives
    back the original tensors."""
    rng = np.random.default_rng(b)
    ring = {"k": _t(rng.standard_normal((b, 8, 2, 4)).astype(np.float32)),
            "v": _t(rng.standard_normal((b, 8, 2, 4)).astype(np.float32)),
            "pos": _t(rng.integers(-1, 8, (b, 8)).astype(np.int32))}
    state = {"h": torch.ones(b, 3)}
    sh = spmd.shard_cache([ring, state], _mesh())
    assert sh[1] is state and sh[0]["k"].lane_split == (b == 4)
    assert len(sh[0]["k"].parts) == (2 if b == 4 else 1)
    assert sh[0]["k"].parts[0][0].shape == ((b // 2 if b == 4 else b), 2, 2, 4)
    back = spmd.gather_cache(sh)
    assert all(torch.equal(back[0][n], ring[n]) for n in ring)
    pool = {"k": torch.randn(16, 4, 2, 4), "v": torch.randn(16, 4, 2, 4),
            "pos": torch.arange(64, dtype=torch.int32).reshape(16, 4)}
    sp = spmd.shard_layer(pool, _mesh(), paged=True)
    assert sp["pos"].parts[0][1].shape == (5, 4)
    assert (sp["pos"].parts[0][1][4] == -1).all()
    assert all(torch.equal(sp[n].gather(), pool[n]) for n in pool)
    rows, within = torch.tensor([1, 6, 15]), torch.tensor([0, 3, 2])
    assert torch.equal(sp["pos"][rows, within], pool["pos"][rows, within])
    sp["pos"][rows, within] = torch.tensor([-5, -6, -7], dtype=torch.int32)
    pool["pos"][rows, within] = torch.tensor([-5, -6, -7], dtype=torch.int32)
    assert torch.equal(sp["pos"].gather(), pool["pos"])
    sp["k"][9].copy_(sp["k"][2])
    assert torch.equal(sp["k"].gather()[9], pool["k"][2])
    with pytest.raises(ValueError, match="split"):
        spmd.shard_layer({"k": torch.zeros(2, 6, 1, 4),
                          "v": torch.zeros(2, 6, 1, 4),
                          "pos": torch.zeros(2, 6, dtype=torch.int32)},
                         _mesh())

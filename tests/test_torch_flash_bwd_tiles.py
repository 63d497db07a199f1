"""The tile decomposition and rounding of the bf16 flash backward, on the
CPU.

``csrc/flash_attention_bwd.cu`` computes ``flash_attention_bwd_plain``'s
function on the tensor cores in two kernels.  The dK/dV kernel owns a
64-key tile of one KV head and walks the (query tile, head) pairs of its
GQA group, query tile by query tile and head by head, over the query
tiles that its keys' positions can meet (32 rows at D 128, 64 at D 64):
it forms ``Sᵀ = K Qᵀ`` and ``dPᵀ = V dOᵀ`` from bf16 operands with f32
sums, ``P = exp(S scale - lse)`` and ``dS = P (dP - delta)`` in f32, and
adds ``Pᵀ dO`` into dV and ``dSᵀ Q`` into dK, the even pairs in one sum
and the odd ones in another, which are added at the end.  At D 256 the
pairs of a key tile are split by head group (``bwd_kv_groups``: equal
groups of the GQA group's heads), a block walking its group's heads
only; each group's sum is an f32 partial, and a second kernel adds the
partials in group order before dK's scale and the one rounding (two
blocks also share each key tile there, each owning half of dK's and dV's
columns over the same S and dP, and a block takes two key tiles one
after the other: neither changes a sum).  The dQ kernel
owns a 64-row query tile of one head and walks the 64-key tiles (32 at D
256) in order, adding ``dS K``.  P and dS enter their products split into bf16 ``hi =
bf16(x)`` and ``lo = bf16(x - hi)``, both multiplied by the bf16 operand.
``_render`` is that decomposition in plain PyTorch, the split emulated by
bf16 casts; a key tile that no query of a dQ block can see adds exact
zeros, which the kernel skips.

In f32 (no split, no rounding) it must give ``jax.vjp`` of the reference's
``ref.mha_cache_masked`` under the same mask within 1e-5 + 1e-5 relative.
With the split, bf16 inputs must stay within one bf16 spacing of
``flash_attention_bwd_plain`` in f32 (the limit ``chip_smoke.py`` holds
the kernel to, floored at the spacing of max|grad| / 256): the seeded
cases read 0.50-0.58 spacings, one rounding of the gradient being 0.5.
With the ``lo`` halves dropped they read 20-75 spacings in each of dq, dk
and dv (each term then errs by 2^-9 of itself, and a gradient near zero
is held to the spacing at 1/256 of the largest), and must miss the
limit.  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` (phase 2t) holds it to the same limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fk

SPACINGS = 1.0          # chip_smoke.BWD_SPACINGS
KEY_TILE = fk.BWD_KEY_TILE  # keys of a dK/dV block and of a dQ step
# the SMs the D 256 head groups are planned for: at these small shapes a
# plan for the H100's 132 gives one head a group, one for 16 several
SMS = 16
DQ_ROWS = 64            # queries of a dQ block
REPS = (1, 2, 4, 6, 16)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _operand(t, mode):
    """An f32 operand as the kernel feeds it to the tensor cores: as is
    ("f32"), split into bf16 hi + lo ("hilo"), or hi alone ("hi")."""
    if mode == "f32":
        return t
    hi = _bf(t)
    return hi + _bf(t - hi) if mode == "hilo" else hi


def _meet(qlo, qhi, klo, khi, causal, window) -> bool:
    """Whether some query position in [qlo, qhi] can see some key position
    in [klo, khi] (the kernels' test of a tile pair)."""
    if klo > khi or qlo > qhi:
        return False
    return (not causal or klo <= qhi) and (window <= 0 or khi > qlo - window)


def _render(q, k, v, out, lse, dout, q_pos, k_pos, causal, window, scale,
            mode):
    """The two kernels' tile walk over f32 tensors holding the inputs
    (bf16 values for "hilo"/"hi"): (dq, dk, dv), rounded to bf16 unless
    mode is "f32"."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    m = fk._mask(q_pos, k_pos, b, s, t, causal, window, q.device)
    m = m.expand(b, s, t)
    qpos = fk._positions(q_pos, b, s, q.device)
    kpos = fk._positions(k_pos, b, t, q.device)
    delta = (dout * out).sum(-1)                               # B S H
    bq = 32 if d >= 128 else 64
    dk = torch.zeros(b, t, hkv, d)
    dv = torch.zeros(b, t, hkv, d)
    groups = fk.bwd_kv_groups(b, t, hq, hkv, SMS) if d > 128 else 1
    for bb in range(b):                                        # dK/dV blocks
        for k0 in range(0, t, KEY_TILE):
            ks = slice(k0, k0 + KEY_TILE)
            live_k = kpos[bb, ks][kpos[bb, ks] >= 0]
            klo, khi = ((live_k.min().item(), live_k.max().item())
                        if len(live_k) else (1, 0))
            tiles = [q0 for q0 in range(0, s, bq)
                     if _meet(qpos[bb, q0:q0 + bq].min().item(),
                              qpos[bb, q0:q0 + bq].max().item(), klo, khi,
                              causal, window)]
            total = torch.zeros(2, min(KEY_TILE, t - k0), hkv, d)  # dk/dv
            for g in range(groups):                            # group order
                heads_g = range(g * rep // groups, (g + 1) * rep // groups)
                pairs = [(q0, hh) for q0 in tiles for hh in heads_g]
                sums = torch.zeros(2, 2, min(KEY_TILE, t - k0), hkv, d)
                for i, (q0, hh) in enumerate(pairs):           # set i % 2
                    qs = slice(q0, q0 + bq)
                    heads = torch.arange(hkv) * rep + hh       # one per block
                    qq = q[bb, qs][:, heads]
                    oo = dout[bb, qs][:, heads]                # q H d
                    st = torch.einsum("khd,qhd->hkq", k[bb, ks], qq)
                    seen = m[bb, qs, ks].T[None]
                    lq = lse[bb, heads, qs][:, None, :]
                    p = torch.where(seen, torch.exp(st * scale - lq), 0.0)
                    dpt = torch.einsum("khd,qhd->hkq", v[bb, ks], oo)
                    dl = delta[bb, qs][:, heads].T[:, None]
                    ds = p * (dpt - dl)
                    sums[i % 2, 1] += torch.einsum("hkq,qhd->khd",
                                                   _operand(p, mode), oo)
                    sums[i % 2, 0] += torch.einsum("hkq,qhd->khd",
                                                   _operand(ds, mode), qq)
                total = total + (sums[0] + sums[1])            # the partial
            dk[bb, ks] = total[0]
            dv[bb, ks] = total[1]
    kx, vx = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    dq = torch.zeros_like(q)
    bk = 32 if d > 128 else KEY_TILE
    for q0 in range(0, s, DQ_ROWS):                            # dQ blocks
        qs = slice(q0, q0 + DQ_ROWS)
        for k0 in range(0, t, bk):
            ks = slice(k0, k0 + bk)
            sc = torch.einsum("bqhd,bkhd->bhqk", q[:, qs], kx[:, ks])
            p = torch.where(m[:, qs, ks][:, None],
                            torch.exp(sc * scale - lse[:, :, qs][..., None]),
                            0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dout[:, qs], vx[:, ks])
            ds = p * (dp - delta[:, qs].transpose(1, 2)[..., None])
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", _operand(ds, mode),
                                      kx[:, ks])
    grads = (dq * scale, dk * scale, dv)
    return grads if mode == "f32" else tuple(_bf(g) for g in grads)


def _spacings(got, exp32) -> float:
    """Largest |got - exp32| in bf16 spacings at |exp32|, floored at the
    spacing of max|exp32| / 256 (``chip_smoke.bwd_spacings``)."""
    mag = exp32.abs().clamp_min(exp32.abs().max().item() / 256 + 1e-30)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - exp32).abs() / spacing).max().item()


def _case(rep, d, masks, bf16):
    """Seeded inputs: "causal" (S = T = 100, window 40, a tenth of the keys
    holes) or "wide" (not causal, 40 queries over 150 keys with holes);
    two KV heads (one at ratio 16); key 0 is never a hole, so every query
    sees a key.  Returns the tensors, the kwargs and the mask."""
    rng = np.random.default_rng(rep * 1000 + d + (masks == "wide"))
    hkv = 2 if rep < 16 else 1
    hq = hkv * rep
    b = 2
    if masks == "causal":
        s, t, causal, window = 100, 100, True, 40
    else:
        s, t, causal, window = 40, 150, False, 0
    cast = _bf if bf16 else (lambda x: x)

    def rnd(shape):
        return cast(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)))

    q, k, v = rnd((b, s, hq, d)), rnd((b, t, hkv, d)), rnd((b, t, hkv, d))
    dout = rnd((b, s, hq, d))
    kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kp[rng.random((b, t)) < 0.1] = -1
    kp[:, 0] = 0
    qp = np.arange(t - s, t, dtype=np.int32)
    kw = dict(q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp),
              causal=causal, window=window, scale=d ** -0.5)
    m = np.broadcast_to(kp[:, None, :] >= 0, (b, s, t)).copy()
    if causal:
        m &= kp[:, None, :] <= qp[None, :, None]
    if window:
        m &= kp[:, None, :] > qp[None, :, None] - window
    assert m.any(-1).all()
    return (q, k, v, dout), kw, m


def _forward(q, k, v, kw, bf16):
    out, lse = fk.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (_bf(out) if bf16 else out), lse


@pytest.mark.parametrize("masks", ["causal", "wide"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 6, 16])
def test_tile_walk_f32_matches_jax_vjp(rep, d, masks):
    """The decomposition in f32 is the backward of the reference's masked
    attention: ``jax.vjp`` of ``ref.mha_cache_masked``."""
    (q, k, v, dout), kw, m = _case(rep, d, masks, bf16=False)
    f = lambda q_, k_, v_: jref.mha_cache_masked(
        q_, k_, v_, mask=jnp.asarray(m), scale=kw["scale"])
    _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    out, lse = _forward(q, k, v, kw, bf16=False)
    got = _render(q, k, v, out, lse, dout, kw["q_pos"], kw["k_pos"],
                  kw["causal"], kw["window"], kw["scale"], "f32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("masks", ["causal", "wide"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("rep", REPS)
def test_split_within_one_spacing(rep, d, masks):
    """bf16 inputs through the hi/lo split stay within one bf16 spacing of
    the f32 oracle, each of dq, dk and dv."""
    (q, k, v, dout), kw, _ = _case(rep, d, masks, bf16=True)
    out, lse = _forward(q, k, v, kw, bf16=True)
    want = fk.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    got = _render(q, k, v, out, lse, dout, kw["q_pos"], kw["k_pos"],
                  kw["causal"], kw["window"], kw["scale"], "hilo")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        sp = _spacings(g, w)
        assert sp <= SPACINGS, f"{name}: {sp:.3f} bf16 spacings"


@pytest.mark.parametrize("masks", ["causal", "wide"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("rep", REPS)
def test_without_lo_misses_the_limit(rep, d, masks):
    """The same walk with P and dS rounded once to bf16 (``hi`` alone)
    misses the limit: the split is what holds the kernel to it."""
    (q, k, v, dout), kw, _ = _case(rep, d, masks, bf16=True)
    out, lse = _forward(q, k, v, kw, bf16=True)
    want = fk.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    got = _render(q, k, v, out, lse, dout, kw["q_pos"], kw["k_pos"],
                  kw["causal"], kw["window"], kw["scale"], "hi")
    assert max(_spacings(g, w) for g, w in zip(got, want)) > SPACINGS

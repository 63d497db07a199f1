"""The tensor-core decomposition and rounding of the bf16 SSD backward, on
the CPU.

``csrc/ssd_scan_bwd.cu`` computes ``ssd_bwd_plain``'s function in bf16 on
the tensor cores, every product with one exact bf16 operand (x, dy, B or
C) and, where the other is f32, that one split into bf16 ``hi = bf16(v)``
and ``lo = bf16(v - hi)``, both multiplied:

  * the chunk states ``(B * exp(total - cum) dt)ᵀ x`` and the carried
    gradient's local terms ``(C * exp(cum))ᵀ dy``, the weighted B and C
    split; the pass over chunks in f32 as before;
  * a block owns a (batch row, chunk) and a group of heads
    (``ssd_scan.bwd_head_group``), and forms ``B Cᵀ`` once for them; per
    head, ``M1ᵀ = (B Cᵀ) * Lᵀ`` and ``M2ᵀ = Lᵀ * DXᵀ`` (``DXᵀ = x dyᵀ``
    times dt_j, exact) give ``d xb = f (B G) + M1ᵀ dy`` and ``dB = f dt (x
    Gᵀ) + M2ᵀ C``, and ``M2 = L * DX`` gives ``dC = e (dy Hᵀ) + M2 B``,
    M1, M2, G and H split; d cum gathers ``-colsum(M1 * DX) - w + e (dy
    Hᵀ) . C + rowsum(M1 * DX)``;
  * the heads' dB and dC are added in head order into the group's f32
    plane, and the planes in group order before the one rounding.

``_render`` is that decomposition in plain PyTorch, the split emulated by
bf16 casts.  In f32 (no split, no rounding) it must give ``jax.vjp`` of
the reference's ``ref.ssd_chunked`` within 1e-5 relative (d a_log and d D,
sums over every (b, s), within 1e-5 of the sums of their terms'
magnitudes).  At bf16 inputs, with the split, it must stay within one
bf16 spacing (``chip_smoke.BWD_SPACINGS``) of ``ssd_bwd_plain`` in f32 on
the same inputs, d a_log and d D within 1e-5 of their terms' magnitudes,
the limits ``chip_smoke.py`` holds the kernel to; with the ``lo`` halves
dropped it must miss them.  The CUDA kernel itself runs only on the card,
where ``chip_smoke.py`` (phase 2t) holds it to the same limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan as sk

SPACINGS = chip_smoke.BWD_SPACINGS
F32 = torch.float32


def _bf(t):
    return t.to(torch.bfloat16).float()


def _op(t, mode):
    """An f32 operand as the kernel feeds it to the tensor cores: as is
    ("f32"), split into bf16 hi + lo ("hilo"), or hi alone ("hi")."""
    if mode == "f32":
        return t
    hi = _bf(t)
    return hi + _bf(t - hi) if mode == "hilo" else hi


def _render(x, dt, a_log, bm, cm, d_skip, dy, chunk, group, mode):
    """The bf16 kernels' decomposition over f32 tensors holding the inputs
    (bf16 values for "hilo"/"hi"): (dx, ddt, da_log, db, dc, dd), dx, ddt,
    db and dc rounded to bf16 unless mode is "f32"."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    q, nc = chunk, s // chunk
    a = -torch.exp(a_log.to(F32))
    xs = x.reshape(bsz, nc, q, h, p)
    ys = dy.reshape(bsz, nc, q, h, p)
    dts = dt.reshape(bsz, nc, q, h)
    bs, cs = bm.reshape(bsz, nc, q, n), cm.reshape(bsz, nc, q, n)
    cum = torch.cumsum(dts * a, dim=2)
    total = cum[:, :, -1]
    e, f = torch.exp(cum), torch.exp(total[:, :, None] - cum)  # (B,NC,Q,H)
    # the states kernel: each chunk's state and local term, weights split
    st = torch.einsum("bcqhn,bcqhp->bchnp",
                      _op(bs[:, :, :, None] * (f * dts)[..., None], mode), xs)
    loc = torch.einsum("bcqhn,bcqhp->bchnp",
                       _op(cs[:, :, :, None] * e[..., None], mode), ys)
    # the pass over chunks (f32): H_c forward, G_{c+1} in reverse
    hin, gst = torch.zeros_like(st), torch.zeros_like(loc)
    run = torch.zeros_like(st[:, 0])
    for c in range(nc):
        hin[:, c] = run
        run = torch.exp(total[:, c])[..., None, None] * run + st[:, c]
    run = torch.zeros_like(loc[:, 0])
    for c in reversed(range(nc)):
        gst[:, c] = run
        run = loc[:, c] + torch.exp(total[:, c])[..., None, None] * run
    # the chunk kernel
    ii = torch.arange(q)
    causal = ii[None, :] >= ii[:, None]                      # [j][i]: i >= j
    cbt = torch.einsum("bcjn,bcin->bcji", bs, cs)            # B Cᵀ, shared
    ng = -(-h // group)
    dbg = torch.zeros(ng, bsz, nc, q, n)
    dcg = torch.zeros(ng, bsz, nc, q, n)
    dx = torch.zeros(bsz, nc, q, h, p)
    ddt = torch.zeros(bsz, nc, q, h)
    apart = torch.zeros(bsz, nc, h)
    dpart = torch.zeros(bsz, nc, h)
    for g in range(ng):
        for hh in range(g * group, min(h, (g + 1) * group)):  # head order
            xh, yh, dth = xs[..., hh, :], ys[..., hh, :], dts[..., hh]
            ch, fh, eh = cum[..., hh], f[..., hh], e[..., hh]
            gh, hh_ = gst[:, :, hh], hin[:, :, hh]           # (B,NC,N,P)
            # rows j: DXᵀ, M1ᵀ, M2ᵀ
            dxt = torch.einsum("bcjp,bcip->bcji", xh, yh) * dth[..., None]
            lt = torch.where(causal, torch.exp(ch[:, :, None, :]
                                               - ch[..., None]), 0.0)
            m1t = cbt * lt
            t = m1t * dxt                                    # Tᵀ
            dcum = -t.sum(-1)
            rows_t = t.sum(-2)                               # rowsum_i(T)
            dxb = (fh[..., None] * torch.einsum("bcjn,bcnp->bcjp", bs,
                                                _op(gh, mode))
                   + torch.einsum("bcji,bcip->bcjp", _op(m1t, mode), yh))
            dx[..., hh, :] = dxb * dth[..., None] + (
                0.0 if d_skip is None else d_skip[hh] * yh)
            dxx = (dxb * xh).sum(-1)
            m2t = lt * dxt
            xg = torch.einsum("bcjp,bcnp->bcjn", xh, _op(gh, mode))
            w = (xg * bs).sum(-1) * (fh * dth)
            db_h = ((fh * dth)[..., None] * xg
                    + torch.einsum("bcji,bcin->bcjn", _op(m2t, mode), cs))
            # rows i: M2 = L * DX
            dyh = torch.einsum("bcip,bcnp->bcin", yh, _op(hh_, mode))
            cr = (dyh * cs).sum(-1) * eh
            dc_h = (eh[..., None] * dyh
                    + torch.einsum("bcij,bcjn->bcin",
                                   _op(m2t.transpose(-1, -2), mode), bs))
            dcum = (dcum - w + cr) + rows_t
            dtot = w.sum(-1) + torch.exp(total[..., hh]) * (gh * hh_).sum(
                (-2, -1))
            dcum[..., -1] += dtot
            dl = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
            ddt[..., hh] = dl * a[hh] + dxx
            apart[..., hh] = (dl * dth).sum(-1)
            dpart[..., hh] = (yh * xh).sum((-2, -1))
            dbg[g] = dbg[g] + db_h                           # head order
            dcg[g] = dcg[g] + dc_h
    db, dc = torch.zeros(bsz, nc, q, n), torch.zeros(bsz, nc, q, n)
    for g in range(ng):                                      # group order
        db, dc = db + dbg[g], dc + dcg[g]
    da_log = apart.sum((0, 1)) * a
    dd = None if d_skip is None else dpart.sum((0, 1))
    outs = [dx.reshape(x.shape), ddt.reshape(dt.shape), da_log,
            db.reshape(bm.shape), dc.reshape(cm.shape), dd]
    if mode != "f32":
        for i in (0, 1, 3, 4):
            outs[i] = _bf(outs[i])
    return tuple(outs)


# (B, NC, chunk, H, P, N, group): chunks 16, 5 and 2, one chunk and
# several, P 16-64, N 32-128, head counts the group divides and not
CASES = [(2, 3, 16, 4, 64, 128, 2), (1, 1, 16, 3, 32, 64, 2),
         (2, 2, 5, 5, 16, 32, 2), (1, 4, 2, 3, 64, 128, 3),
         (1, 1, 2, 2, 16, 96, 1), (2, 4, 16, 6, 32, 48, 4)]
IDS = [f"B{c[0]}-nc{c[1]}-Q{c[2]}-H{c[3]}-P{c[4]}-N{c[5]}-g{c[6]}"
       for c in CASES]


def _inputs(case, seed, dtype):
    b, nc, q, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    x, dt, a_log, bm, cm, d_skip = chip_smoke.ssd_inputs(
        rng, b, nc * q, h, p, n, dtype, "cpu")
    dy = torch.from_numpy(rng.standard_normal((b, nc * q, h, p)).astype(
        np.float32)).to(dtype)
    return [t.float() for t in (x, dt)] + [a_log] + [
        t.float() for t in (bm, cm)] + [d_skip, dy.float()]


def _misses(got, x, dt, a_log, bm, cm, d_skip, dy, chunk):
    """The limits chip_smoke.check_ssd_bwd holds the kernel to, against
    ssd_bwd_plain in f32: (worst bf16 spacings of dx, ddt, dB, dC; worst
    share of the 1e-5 limit of d a_log and d D)."""
    exp = sk.ssd_bwd_plain(x, dt, a_log, bm, cm, d_skip, dy, chunk=chunk)
    sa, sd = sk.ssd_param_scales(x, dt, a_log, bm, cm, dy, chunk)
    spac, share = 0.0, 0.0
    for name, g, e in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          exp):
        if name in ("da_log", "dd"):
            lim = 1e-5 * (sa if name == "da_log" else sd) + 1e-6
            share = max(share, ((g - e).abs() / lim).max().item())
        else:
            spac = max(spac, chip_smoke.bwd_spacings(g, e))
    return spac, share


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decomposition_f32_matches_jax_vjp(case):
    """In f32 the tensor-core decomposition is the backward of the
    reference's ``ref.ssd_chunked``: ``jax.vjp`` of it."""
    x, dt, a_log, bm, cm, d_skip, dy = _inputs(case, 7, torch.float32)
    chunk, group = case[2], case[6]
    args = [t.numpy() for t in (x, dt, a_log, bm, cm, d_skip)]
    want = jax.jit(lambda dy_, *a: jax.vjp(
        lambda *b: jref.ssd_chunked(*b, chunk=chunk), *a)[1](dy_))(
        jnp.asarray(dy.numpy()), *map(jnp.asarray, args))
    got = _render(x, dt, a_log, bm, cm, d_skip, dy, chunk, group, "f32")
    sa, sd = sk.ssd_param_scales(x, dt, a_log, bm, cm, dy, chunk)
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          want):
        w = np.asarray(w)
        if name in ("da_log", "dd"):
            lim = 1e-5 * (sa if name == "da_log" else sd).numpy() + 1e-7
            np.testing.assert_array_less(np.abs(g.numpy() - w), lim, name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_within_limits(case):
    """bf16 inputs through the hi/lo split stay within one bf16 spacing of
    the f32 oracle (dx, ddt, dB, dC) and within 1e-5 of the terms'
    magnitudes (d a_log, d D)."""
    ins = _inputs(case, 11, torch.bfloat16)
    got = _render(*ins, case[2], case[6], "hilo")
    spac, share = _misses(got, *ins, case[2])
    assert spac <= SPACINGS, f"{spac:.3f} bf16 spacings"
    assert share <= 1.0, f"{share:.3f} of the 1e-5 limit"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_without_lo_misses_the_limits(case):
    """The same decomposition with the f32 operands rounded once to bf16
    (``hi`` alone) misses the limits: the split is what holds the kernel
    to them."""
    ins = _inputs(case, 11, torch.bfloat16)
    got = _render(*ins, case[2], case[6], "hi")
    spac, share = _misses(got, *ins, case[2])
    assert spac > SPACINGS or share > 1.0


def test_head_group_plan():
    """The wrapper's plan: six heads a block at mamba2-780m's training
    shape (B 2, S 1024, 48 heads, chunk 128: 128 blocks, one wave of
    132 SMs), one where more blocks fill the card, and never more than
    BWD_MAX_GROUP or the head count; at 47 heads the last group of six
    holds five (the card's check of a short last group)."""
    assert sk.bwd_head_group(2, 1024, 48, 128, 132) == 6
    assert sk.bwd_head_group(2, 1024, 47, 128, 132) == 6
    assert sk.bwd_head_group(1, 100, 48, 100, 132) == 1
    assert sk.bwd_head_group(1, 130, 48, 2, 132) == sk.BWD_MAX_GROUP
    assert sk.bwd_head_group(1, 16, 3, 16, 132) == 1
    assert sk.bwd_workspace(2, 1024, 48, 64, 128, 128, 6) == (
        2 * 8 * 48 * (2 * 128 * 64 + 3) + 2 * 2 * 1024 * 8 * 128)

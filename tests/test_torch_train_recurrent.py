"""Training the recurrent stacks: the port's backward of ``ssd``,
``rglru``, the gated norm and flash attention at head_dim 256, held
against the JAX package on the CPU.

  * each plain backward (``ssd_bwd_plain``, ``rglru_bwd_plain``,
    ``gated_rmsnorm_bwd_plain``, ``flash_attention_bwd_plain`` at D 256,
    16 query heads over 1, window 16) against ``jax.vjp`` of the JAX
    function, in f32: every gradient within 1e-5 of the largest |gradient|
    of its tensor plus 1e-5 relative (f32 sums in another order; the SSD
    and the RG-LRU sum over up to 600 steps);
  * the SSD backward's decomposition (the forward pass for the incoming
    states, the reverse pass for the carried state's gradient, the
    per-chunk terms and the reverse cumsum into d(dt)) against autograd
    through the same forward cut into those pieces, and the RG-LRU
    backward's cut of time (``rglru_scan.plan``: each tile's incoming
    state from the forward's checkpoint, tiles last to first, segments
    scanned forward and in reverse from zero and their pairs folded)
    against
    ``rglru_bwd_plain``, both in float64 to 1e-10;
  * the loss and every parameter's gradient of the mamba2-780m and
    recurrentgemma-9b smoke configs (f32) against ``jax.value_and_grad``
    of the reference's loss on bridged weights, and three
    ``make_train_step`` steps of each against the reference's:
    ``test_torch_training.py``'s tests at these configs, with its
    tolerances (loss 1e-5 relative, gradients 1e-5 + 1e-4 relative,
    parameters after the steps 5e-5).

Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_training as training_tests
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import ssd_scan as sk

EPS = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, err=""):
    """Within 1e-5 of the tensor's largest |want| plus 1e-5 relative;
    inf and NaN where ``want`` has them."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, err
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)], err)
    if fin.any():
        scale = max(1.0, float(np.abs(want[fin]).max()))
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=err)


# ------------------------------------------------- plain backward vs jax.vjp
SSD_CASES = [(128, 1), (128, 2), (100, 1), (100, 3), (17, 1), (17, 3),
             (2, 1), (2, 6)]


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("chunk,nc", SSD_CASES)
def test_ssd_bwd_plain_matches_jax_vjp(chunk, nc, skip):
    rng = np.random.default_rng(chunk * 10 + nc)
    b, h, p, n = 2, 3, 4, 8
    s = chunk * nc
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.4 + 0.05).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    args = [x, dt, a_log, bm, cm] + ([d] if skip else [])

    def f(*a):
        return jref.ssd_chunked(*a[:5], a[5] if skip else None, chunk=chunk)
    want = jax.jit(lambda dy_, *a: jax.vjp(f, *a)[1](dy_))(
        jnp.asarray(dy), *map(jnp.asarray, args))
    T = [torch.from_numpy(a) for a in args]
    got = sk.ssd_bwd_plain(*T[:5], T[5] if skip else None,
                           torch.from_numpy(dy), chunk=chunk)
    assert (got[5] is None) == (not skip)
    scales = dict(zip(("da_log", "dd"), sk.ssd_param_scales(
        *T[:5], torch.from_numpy(dy), chunk)))
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          want):
        if name in scales:
            # a sum over every (b, s) of a head: 1e-5 of the sum of its
            # terms' magnitudes (JAX's own f32 value lies 2.3e-5 of itself
            # from the float64 one at chunk 128, a cancelling sum)
            np.testing.assert_array_less(np.abs(_np(g) - _np(w)),
                                         1e-5 * _np(scales[name]) + 1e-7,
                                         name)
        else:
            _close(g, w, name)


@pytest.mark.parametrize("s", [1, 2, 17, 128, 129, 600])
def test_rglru_bwd_plain_matches_jax_vjp(s):
    """Including steps where ``1 - a^2 = 0`` (log_a = 0), where
    ``jax.grad`` gives d log_a = -inf or NaN, and ``rglru_bwd_plain`` the
    same."""
    rng = np.random.default_rng(s)
    shape = (2, s, 24)
    x = rng.standard_normal(shape).astype(np.float32)
    la = (-np.abs(rng.standard_normal(shape)) * 0.3).astype(np.float32)
    la[0, 0, :3] = 0.0
    la[1, -1, 5] = 0.0
    x[1, -1, 5] = 0.0                                  # dh x gate = 0: NaN
    g = rng.random(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    want = jax.jit(lambda *a: jax.vjp(jref.rglru_chunked, *a[:3])[1](a[3]))(
        *map(jnp.asarray, (x, la, g, dy)))
    got = rg.rglru_bwd_plain(*map(torch.from_numpy, (x, la, g, dy)))
    assert np.isinf(_np(want[1])[0, 0, :3]).all()
    _close(got[0], want[0], "dx")
    _close(got[2], want[2], "dgate")
    # d log_a carries 1 / (1 - a^2) (through 1 / beta): one rounding of
    # exp(2 log_a) moves it by 2^-24 / (1 - a^2) of itself, on either side
    w, gg = _np(want[1]), _np(got[1])
    fin = np.isfinite(w)
    _close(np.where(fin, w, gg), w, "dlog_a (inf, NaN)")
    w, gg = w[fin], gg[fin]
    u = 1.0 - np.exp(2.0 * la.astype(np.float64)[fin])
    lim = (1e-5 * max(1.0, np.abs(w).max()) + 1e-5 * np.abs(w)
           + np.abs(w) * 2.0 ** -23 / u)
    assert (np.abs(gg - w) <= lim).all(), "dlog_a"


def test_gated_norm_bwd_plain_matches_jax_vjp():
    rng = np.random.default_rng(11)
    shape, d = (3, 7, 96), 96
    y, z, dout = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(3))
    scale = (rng.standard_normal(d) * 0.1).astype(np.float32)

    def f(y_, z_, s_):                    # as repro.models.ssm gates its norm
        return jlayers.rmsnorm({"scale": s_}, y_ * jax.nn.silu(z_), EPS)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (y, z, scale)))
    want = vjp(jnp.asarray(dout))
    got = rk.gated_rmsnorm_bwd_plain(*map(torch.from_numpy, (y, z, scale,
                                                             dout)), EPS)
    for name, g, w in zip(("dy", "dz", "dscale"), got, want):
        _close(g, w, name)


def test_flash_bwd_plain_d256_matches_jax_vjp():
    """recurrentgemma-9b's local attention: D 256, 16 query heads over one,
    causal with a window of 16."""
    rng = np.random.default_rng(256)
    b, s, hq, hkv, d, window = 2, 40, 16, 1, 256, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    m = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    m = np.broadcast_to(m, (b, s, s))
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.mha_cache_masked(
        q_, k_, v_, mask=jnp.asarray(m), scale=scale), *map(jnp.asarray,
                                                           (q, k, v)))
    want = vjp(jnp.asarray(do))
    T = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
              causal=True, window=window, scale=scale)
    out, lse = fk.flash_attention_plain(*T, return_lse=True, **kw)
    got = fk.flash_attention_bwd_plain(*T, out, lse, torch.from_numpy(do),
                                       **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


# --------------------------------------------- the SSD backward, piece by piece
def _ssd_parts(ld, xb, bm, cm, states_leaf=None, h_in=None):
    """``ref.ssd_chunked``'s forward on chunked f64 terms, without d_skip:
    (y (B,NC,Q,H,P), the state each chunk carries out ``exp(total) h_in +
    own state``, the incoming states).  ``states_leaf`` replaces the
    chunks' own states in the recurrence; ``h_in`` replaces the incoming
    states."""
    cum = torch.cumsum(ld, 2)
    total = cum[:, :, -1]
    L = torch.exp(tref.segsum(ld.permute(0, 1, 3, 2)))
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    y = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * L, xb)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bm,
                          torch.exp(total[:, :, None] - cum), xb)
    if h_in is None:
        src = states if states_leaf is None else states_leaf
        hs, before = torch.zeros_like(src[:, 0]), []
        for c in range(src.shape[1]):
            before.append(hs)
            hs = torch.exp(total[:, c])[..., None, None] * hs + src[:, c]
        h_in = torch.stack(before, 1)
    y = y + torch.einsum("bcqn,bcqh,bchnp->bcqhp", cm, torch.exp(cum), h_in)
    return y, torch.exp(total)[..., None, None] * h_in + states, h_in


def _ssd_terms(rng, b, nc, q, h, p, n):
    def r(*shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * s)
    ld = -torch.from_numpy(rng.random((b, nc, q, h)) * 0.3 + 0.01)
    return ld, r(b, nc, q, h, p), r(b, nc, q, n), r(b, nc, q, n)


@pytest.mark.parametrize("chunk,nc", [(16, 1), (16, 3), (5, 4), (2, 6)])
def test_ssd_bwd_decomposition(chunk, nc):
    """Float64: the forward pass's incoming states equal the reference's
    recurrence; the reverse pass gives autograd's gradient of each chunk's
    state; the per-chunk terms give autograd's gradients of xb, B, C (the
    heads' shares summed) with the incoming state held fixed and the
    carried-out state's gradient given, and the reverse cumsum of d cum (d
    total joined to the last step) gives the log decays' gradient."""
    rng = np.random.default_rng(chunk + nc)
    b, h, p, n = 2, 3, 4, 5
    ld, xb, bm, cm = _ssd_terms(rng, b, nc, chunk, h, p, n)
    dy = torch.from_numpy(rng.standard_normal((b, nc, chunk, h, p)))
    cum = torch.cumsum(ld, 2)
    total = cum[:, :, -1]
    tight = dict(atol=1e-10, rtol=1e-10)

    y, states, h_ref = _ssd_parts(ld, xb, bm, cm)
    torch.testing.assert_close(sk.ssd_bwd_states(bm, xb, cum, total), h_ref,
                               **tight)
    leaf = states.detach().requires_grad_(True)
    want = torch.zeros_like(leaf)          # one chunk: its state is no input
    if nc > 1:
        y, _, _ = _ssd_parts(ld, xb, bm, cm, states_leaf=leaf)
        (want,) = torch.autograd.grad((y * dy).sum(), leaf)
    dstate = sk.ssd_bwd_carry(cm, dy, cum, total)
    torch.testing.assert_close(dstate, want, **tight)

    h_in = torch.from_numpy(rng.standard_normal((b, nc, h, n, p)))
    leaves = [t.clone().requires_grad_(True) for t in (ld, xb, bm, cm)]
    y, st, _ = _ssd_parts(*leaves, h_in=h_in)
    loss = (y * dy).sum() + (st * dstate).sum()
    want = torch.autograd.grad(loss, leaves)
    dxb, db, dc, dcum, dtotal = sk.ssd_bwd_chunks(ld, cum, total, xb, bm, cm,
                                                  dy, h_in, dstate)
    dcum[:, :, -1] += dtotal
    dl = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    for got, w in zip((dl, dxb, db, dc), want):
        torch.testing.assert_close(got, w, **tight)


# ------------------------------------------ the RG-LRU backward's cut of time
def _rglru_bwd_tiled(x, la, g, dy, segs, per):
    """The kernel's walk in plain PyTorch (float64): each tile's incoming
    state from the forward's checkpoint (the states after each tile but
    the last), then the tiles last to first; in each, every segment
    scanned forward from zero, the earlier segments' pairs folded onto the
    checkpoint for its incoming state and the segment run again from it;
    every segment folded in reverse from zero to (product of its a's, a_0
    dh_0), the later segments' pairs folded onto the carry from the later
    tile, and the segment walked in reverse from that carry."""
    b, s, d = x.shape
    rows = segs * per
    tiles = -(-s // rows)
    a = torch.exp(la)
    bx = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * la), 0)) * g * x
    h, hs = [], torch.zeros(b, d, dtype=x.dtype)
    for t in range(s):
        hs = a[:, t] * hs + bx[:, t]
        h.append(hs)
    ckpt = [torch.zeros(b, d, dtype=x.dtype)] + [h[t * rows - 1]
                                                 for t in range(1, tiles)]

    def seg_range(t, sg):
        lo = t * rows + sg * per
        return lo, max(0, min(per, s - lo))

    dx, dla, dg = (torch.zeros_like(x) for _ in range(3))
    gcarry = torch.zeros(b, d, dtype=x.dtype)
    for t in reversed(range(tiles)):
        hin, pairs = ckpt[t], []
        for sg in range(segs):        # forward pairs, folded in order
            lo, n = seg_range(t, sg)
            hl, pr = torch.zeros(b, d, dtype=x.dtype), 1.0
            for u in range(n):
                hl = a[:, lo + u] * hl + bx[:, lo + u]
                pr = pr * a[:, lo + u]
            pairs.append(hin)
            hin = pr * hin + hl
        revs = []                     # reverse pairs from zero
        for sg in range(segs):
            lo, n = seg_range(t, sg)
            run, pr = 0.0, 1.0
            for u in reversed(range(n)):
                run = (a[:, lo + u + 1] * run if u + 1 < n else 0.0) \
                    + dy[:, lo + u]
                pr = pr * a[:, lo + u]
            revs.append((pr, a[:, lo] * run) if n else (1.0, 0.0))
        gin = gcarry
        for sg in reversed(range(segs)):
            lo, n = seg_range(t, sg)
            hprev, c = [], pairs[sg]
            for u in range(n):
                hprev.append(c)
                c = a[:, lo + u] * c + bx[:, lo + u]
            c = gin
            for u in reversed(range(n)):
                tt = lo + u
                dh = dy[:, tt] + c
                c = a[:, tt] * dh
                beta = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * la[:, tt]),
                                                  0))
                dx[:, tt] = dh * beta * g[:, tt]
                dg[:, tt] = dh * x[:, tt] * beta
                dla[:, tt] = rg._dlog_a(la[:, tt], dh * hprev[u],
                                        dh * x[:, tt] * g[:, tt])
            prod, start = revs[sg]
            gin = start + prod * gin
        gcarry = gin
    return dx, dla, dg


@pytest.mark.parametrize("s,staged", [(s, False) for s in (1, 7, 16, 33, 128)]
                         + [(s, True) for s in (1, 33, 256, 300, 600)])
def test_rglru_bwd_tiles(s, staged):
    """Both paths of ``plan``: one tile (up to 128 steps) and tiles of
    256 steps."""
    rng = np.random.default_rng(s)
    shape = (2, s, 5)
    x = torch.from_numpy(rng.standard_normal(shape))
    la = torch.from_numpy(-np.abs(rng.standard_normal(shape)) * 0.3)
    g = torch.from_numpy(rng.random(shape))
    dy = torch.from_numpy(rng.standard_normal(shape))
    segs, per = rg.plan(s, staged)
    got = _rglru_bwd_tiled(x, la, g, dy, segs, per)
    want = rg.rglru_bwd_plain(x, la, g, dy)
    for gg, w in zip(got, want):
        torch.testing.assert_close(gg, w, atol=1e-10, rtol=1e-10)


# ------------------------------------------------ the stacks against JAX
RECURRENT = ["mamba2-780m", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_gradients_match_reference(arch):
    """``test_torch_training``'s check at the recurrent stacks' smoke
    configs: the loss and every parameter's gradient of one batch against
    ``jax.value_and_grad`` of the reference's loss, every gradient
    nonzero."""
    training_tests.test_loss_gradients_match_reference(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_reference(arch):
    """``test_torch_training``'s three ``make_train_step`` steps against
    the reference's (one microbatch, no compression) at the recurrent
    stacks' smoke configs."""
    training_tests.test_train_step_matches_reference(arch, 1, "none")

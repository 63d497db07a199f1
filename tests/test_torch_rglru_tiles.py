"""The tiled decomposition of the RG-LRU kernel, on the CPU.

``csrc/rglru_scan.cu`` scans ``h_t = a_t h_{t-1} + b_t`` in time tiles of
``segs`` segments of ``per`` steps (``rglru_scan.plan``: one tile of up to
16 segments for a serving chunk, tiles of 32 x 8 steps for a prompt).
Each warp scans its segment from zero and keeps the local states and decay
prefixes.  In one tile each segment folds the (product, end state) pairs
of the segments before it into its incoming state; in a staged tile the
pairs are scanned across a warp's lanes with shuffles (an inclusive
Kogge-Stone scan of the maps ``h -> A h + H``) and the carry, the state
before the tile, turns each segment's exclusive prefix into its incoming
state, the tile's total moving the carry on.  Each segment applies its
incoming state to the values it kept.
``_render`` is that decomposition in plain PyTorch, combining in the
kernel's order; with ``checkpoint`` it also returns the carry after each
tile but the last, which the staged kernel writes for the backward.

It must equal ``ref.rglru_chunked`` and the TPU kernel in interpret mode
within 1e-5 + 1e-5 relative in f32, at S in {1, 7, 32, 33, 128, 129, 300,
600} on both paths (the staged one forced on the short S; 600 crosses two
tile boundaries); bf16 inputs within one bf16 step of the largest
|reference| (2^-7 relative), as ``chip_smoke.py`` holds the kernel.  The
checkpoint must equal ``rglru_checkpoint_plain`` (the plain f32 states at
the tile boundaries) within 1e-5 + 1e-5 relative.

``_render_bwd`` is the backward kernel's walk (``csrc/rglru_scan_bwd.cu``)
in the kernel's order: the tiles last to first; in each, every segment
scanned forward from zero, the segments' pairs shuffle-scanned from the
forward's checkpoint for each segment's incoming state, the segment run
again from it for h_{t-1}; every segment folded in reverse from zero to
(product of its a's, a_0 dh_0), those pairs shuffle-scanned in reversed
segment order from the carry of the later tiles for each segment's carry
of a dh, and the segment walked in reverse from it for dh and the three
gradients.  It must equal ``jax.grad`` of the JAX package's
``ref.rglru_chunked`` at the same S on both paths: f32 within 1e-5 of the
tensor's largest |gradient| + 1e-5 relative (d log_a also within its
1 / (1 - a^2) conditioning, and -inf, +inf or NaN where JAX has them,
where log_a = 0), bf16 inputs (gradients in f32, each rounded once to
bf16) within one bf16 step of the largest |gradient| of the f32 oracle on
the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru as pallas_rglru
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as gk

S_CASES = [1, 7, 32, 33, 128, 129, 300, 600]


def _segment_scan(pa, ph):
    """Inclusive scan of the maps (pa, ph) along dim 2 (segments), in the
    kernel's shuffle order: at distance 1, 2, 4, 8, 16, earlier first."""
    n = pa.shape[2]
    o = 1
    while o < 32:
        if o < n:
            ea, eh = pa[:, :, :-o], ph[:, :, :-o]          # lane s - o
            la, lh = pa[:, :, o:], ph[:, :, o:]
            pa = torch.cat([pa[:, :, :o], ea * la], 2)
            ph = torch.cat([ph[:, :, :o], la * eh + lh], 2)
        o <<= 1
    return pa, ph


def _render(x, log_a, gate_x, staged=None, checkpoint=False):
    """The kernel's decomposition, tiles of ``segs * per`` steps; with
    ``checkpoint`` also the carries after the tiles but the last, (B,
    tiles - 1, D)."""
    a, bx = ref._rglru_terms(x, log_a, gate_x)
    b, s, d = a.shape
    segs, per = gk.plan(s, staged)
    rows = segs * per
    nt = -(-s // rows)
    pad = nt * rows - s
    a = torch.cat([a, torch.ones(b, pad, d)], 1).reshape(b, nt, segs, per, d)
    bx = torch.cat([bx, torch.zeros(b, pad, d)], 1).reshape(a.shape)
    out = torch.empty(a.shape)
    carry = torch.zeros(b, d)
    carries = []
    for t in range(nt):
        # each segment from zero: local states and decay prefixes
        h, prod = torch.zeros(b, segs, d), torch.ones(b, segs, d)
        local, prefix = [], []
        for u in range(per):
            h = a[:, t, :, u] * h + bx[:, t, :, u]
            prod = prod * a[:, t, :, u]
            local.append(h)
            prefix.append(prod)
        if segs == gk.SEGS:
            # the staged tile: a shuffle scan, its exclusive prefix applied
            # to the carry
            ia, ih = _segment_scan(prod[:, None], h[:, None])
            ia, ih = ia[:, 0], ih[:, 0]
            hin = torch.cat([carry[:, None], ia[:, :-1] * carry[:, None]
                             + ih[:, :-1]], 1)
        else:
            # one tile: each segment folds the pairs before it from zero
            hin = torch.zeros(b, segs, d)
            for sg in range(1, segs):
                acc = torch.zeros(b, d)
                for e in range(sg):
                    acc = prod[:, e] * acc + h[:, e]
                hin[:, sg] = acc
        for u in range(per):
            out[:, t, :, u] = local[u] + prefix[u] * hin
        if segs == gk.SEGS:
            carry = ia[:, -1] * carry + ih[:, -1]
            carries.append(carry)
    y = out.reshape(b, -1, d)[:, :s].to(x.dtype)
    if checkpoint:
        return y, torch.stack(carries[:nt - 1] or [torch.zeros(b, d)],
                              1)[:, :nt - 1]
    return y


def _exclusive(pa, ph, carry):
    """Each lane's incoming value from ``_segment_scan`` of the maps (pa,
    ph) along dim 1 (B, lanes, D): lane 0 the carry, lane s the maps of
    lanes < s applied to it; and every lane's maps applied to it."""
    ia, ih = _segment_scan(pa[:, None], ph[:, None])
    ia, ih = ia[:, 0], ih[:, 0]
    before = torch.cat([carry[:, None], ia[:, :-1] * carry[:, None]
                        + ih[:, :-1]], 1)
    return before, ia[:, -1] * carry + ih[:, -1]


def _render_bwd(x, log_a, gate_x, dy, staged=None):
    """The backward kernel's walk in plain PyTorch, f32, in its order:
    (dx, dlog_a, dgate) rounded once to x's dtype."""
    f32 = torch.float32
    b, s, d = x.shape
    segs, per = gk.plan(s, staged)
    rows = segs * per
    nt = -(-s // rows)
    # the forward kernel's checkpoint: each tile's incoming state
    ckpt = _render(x.float(), log_a.float(), gate_x.float(), staged,
                   checkpoint=True)[1] if nt > 1 else None
    pad = nt * rows - s

    def tiles(v, fill):
        v = torch.cat([v.to(f32), torch.full((b, pad, d), fill)], 1)
        return v.reshape(b, nt, segs, per, d)
    # past S: a = 1, b = 0, dy = 0 leave every scan as the kernel's skipped
    # steps leave it
    la, xs, gs, dys = (tiles(v, f) for v, f in ((log_a, 0.0), (x, 0.0),
                                                (gate_x, 0.0), (dy, 0.0)))
    a = torch.exp(la)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * la), 0.0))
    bx = beta * gs * xs
    outs = [torch.empty(b, nt, segs, per, d) for _ in range(3)]
    carry_g = torch.zeros(b, d)
    for t in reversed(range(nt)):
        # forward: each segment from zero, then its incoming state
        h, prod = torch.zeros(b, segs, d), torch.ones(b, segs, d)
        for u in range(per):
            h = a[:, t, :, u] * h + bx[:, t, :, u]
            prod = prod * a[:, t, :, u]
        carry = ckpt[:, t - 1] if t > 0 else torch.zeros(b, d)
        hin, _ = _exclusive(prod, h, carry)
        hprev, hh = [], hin
        for u in range(per):
            hprev.append(hh)
            hh = a[:, t, :, u] * hh + bx[:, t, :, u]
        # reverse: each segment from zero to (product of a, a_0 dh_0)
        run, pr = torch.zeros(b, segs, d), torch.ones(b, segs, d)
        for u in reversed(range(per)):
            run = (a[:, t, :, u + 1] * run if u + 1 < per else 0.0) \
                + dys[:, t, :, u]
            pr = pr * a[:, t, :, u]
        pairs = (torch.flip(pr, [1]), torch.flip(a[:, t, :, 0] * run, [1]))
        gin, total = _exclusive(*pairs, carry_g if segs == gk.SEGS
                                else torch.zeros(b, d))
        gin = torch.flip(gin, [1])
        carry_g = total
        # the segment in reverse from its carry
        c = gin
        for u in reversed(range(per)):
            dh = dys[:, t, :, u] + c
            c = a[:, t, :, u] * dh
            l, gv, xv = la[:, t, :, u], gs[:, t, :, u], xs[:, t, :, u]
            e2 = torch.exp(2.0 * l)
            uu = 1.0 - e2
            bt = torch.sqrt(torch.clamp_min(uu, 0.0))
            coef = torch.where(uu > 0, 1.0, torch.where(uu == 0, 0.5, 0.0))
            dhx = dh * xv
            outs[0][:, t, :, u] = dh * (bt * gv)
            outs[1][:, t, :, u] = dh * hprev[u] * a[:, t, :, u] - (
                dhx * gv * (0.5 / bt)) * coef * e2 * 2.0
            outs[2][:, t, :, u] = dhx * bt
    return tuple(o.reshape(b, -1, d)[:, :s].to(x.dtype) for o in outs)


def _inputs(seed, b, s, d, dtype=torch.float32):
    """As ``chip_smoke.rglru_inputs``: x normal, log_a = -8 softplus(Lambda)
    sigmoid(r) with a^8 spanning 0.9 .. 0.999, a sigmoid gate."""
    rng = np.random.default_rng(seed)
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, d)) / 8.0))
    r = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    log_a = -8.0 * np.log1p(np.exp(lam)) * r
    gate = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    return tuple(torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
                 for v in (rng.standard_normal((b, s, d)), log_a, gate))


def test_plan_cuts_time():
    """The serving chunk is one tile of 16 warps of two steps; a prompt
    takes tiles of 32 x 8 steps; one tile holds at most 128 steps."""
    assert gk.plan(1) == (1, 1)
    assert gk.plan(32) == (16, 2)
    assert gk.plan(33) == (11, 3)
    assert gk.plan(128) == (16, 8)
    assert gk.plan(129) == gk.plan(2300) == (32, 8)
    assert gk.plan(32, staged=True) == (32, 8)
    with pytest.raises(ValueError):
        gk.plan(129, staged=False)


# the planned path at every S, and the staged one forced where a single
# tile would do
PATHS = [(s, None) for s in S_CASES] + [(s, True) for s in S_CASES
                                       if s <= gk.ONE_TILE_SEGS * gk.STEPS]


@pytest.mark.parametrize("s,staged", PATHS)
def test_decomposition_matches_oracles_f32(s, staged):
    """f32 against ``ref.rglru_chunked`` and the TPU kernel (interpret
    mode), on the path ``plan`` takes and on the staged one."""
    args = _inputs(s, 2, s, 24)
    got = _render(*args, staged).numpy()
    np.testing.assert_allclose(got, ref.rglru_chunked(*args).numpy(),
                               atol=1e-5, rtol=1e-5)
    jout = np.asarray(pallas_rglru(*(jnp.asarray(a.numpy()) for a in args),
                                   chunk=64, block_d=24, interpret=True))
    np.testing.assert_allclose(got, jout, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [33, 600])
def test_decomposition_bf16_within_one_step(s):
    """bf16 inputs: the decomposition rounds h once, as the oracle does."""
    args = _inputs(100 + s, 2, s, 24, torch.bfloat16)
    exp = ref.rglru_chunked(*args).float()
    lim = 2.0 ** -7 * max(1.0, exp.abs().max().item())
    assert (_render(*args).float() - exp).abs().max().item() <= lim


def test_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.rglru(x, x, x)


@pytest.mark.parametrize("s,staged", PATHS)
def test_checkpoint_is_the_states_at_tile_boundaries(s, staged):
    """The staged forward's checkpoint (the carry after each tile but the
    last) against the plain f32 states at the tile boundaries."""
    args = _inputs(200 + s, 2, s, 24)
    y, ckpt = _render(*args, staged, checkpoint=True)
    want = gk.rglru_checkpoint_plain(*args, staged)
    assert ckpt.shape == want.shape == (2, gk.tiles(s, staged) - 1, 24)
    np.testing.assert_allclose(ckpt.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(y.numpy(), _render(*args, staged).numpy())


def _jax_grads(x, log_a, gate_x, dy):
    f = jax.jit(lambda *v: jax.vjp(jref.rglru_chunked, *v[:3])[1](v[3]))
    return [np.asarray(g) for g in f(*(jnp.asarray(v.float().numpy())
                                       for v in (x, log_a, gate_x, dy)))]


def _bwd_inputs(seed, s, dtype=torch.float32):
    """``_inputs`` with a few log_a exactly 0 (d log_a -inf, +inf or NaN)
    and dy normal."""
    x, la, g = _inputs(seed, 2, s, 24)
    la[0, 0, :3] = 0.0
    la[1, -1, 5] = 0.0
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (2, s, 24)).astype(np.float32))
    return tuple(v.to(dtype) for v in (x, la, g, dy))


@pytest.mark.parametrize("s,staged", PATHS)
def test_backward_walk_matches_jax_grad_f32(s, staged):
    """The backward kernel's walk against ``jax.grad`` of
    ``ref.rglru_chunked``, f32."""
    args = _bwd_inputs(300 + s, s)
    got = [g.numpy() for g in _render_bwd(*args, staged)]
    want = _jax_grads(*args)
    for name, gg, w in zip(("dx", "dlog_a", "dgate"), got, want):
        np.testing.assert_array_equal(np.isnan(gg), np.isnan(w), name)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(gg[~fin & ~np.isnan(w)],
                                      w[~fin & ~np.isnan(w)], name)
        lim = 1e-5 * max(1.0, np.abs(w[fin]).max()) + 1e-5 * np.abs(w[fin])
        if name == "dlog_a":
            # one rounding of exp(2 log_a) moves it by 2^-23 / (1 - a^2)
            u = 1.0 - np.exp(2.0 * args[1].double().numpy()[fin])
            lim = lim + np.abs(w[fin]) * 2.0 ** -23 / u
        assert (np.abs(gg[fin] - w[fin]) <= lim).all(), name


@pytest.mark.parametrize("s", [33, 600])
def test_backward_walk_bf16_within_one_step(s):
    """bf16 inputs: each gradient in f32, rounded once, within one bf16
    step of the f32 oracle's largest |gradient| on the same inputs (d
    log_a also within its conditioning)."""
    args = _bwd_inputs(400 + s, s, torch.bfloat16)
    got = _render_bwd(*args)
    want = _jax_grads(*args)
    for name, gg, w in zip(("dx", "dlog_a", "dgate"), got, want):
        assert gg.dtype == torch.bfloat16
        gg = gg.float().numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isnan(gg), np.isnan(w), name)
        lim = 2.0 ** -7 * max(1.0, np.abs(w[fin]).max())
        if name == "dlog_a":
            u = 1.0 - np.exp(2.0 * args[1].double().numpy()[fin])
            lim = lim + np.abs(w[fin]) * 2.0 ** -23 / u
        assert (np.abs(gg[fin] - w[fin]) <= lim).all(), name


def test_backward_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.rglru_bwd(x, x, x, x)

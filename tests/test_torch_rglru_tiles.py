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
kernel's order.

It must equal ``ref.rglru_chunked`` and the TPU kernel in interpret mode
within 1e-5 + 1e-5 relative in f32, at S in {1, 7, 32, 33, 128, 129, 300,
600} on both paths (the staged one forced on the short S; 600 crosses two
tile boundaries); bf16 inputs within one bf16 step of the largest
|reference| (2^-7 relative), as ``chip_smoke.py`` holds the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _render(x, log_a, gate_x, staged=None):
    """The kernel's decomposition, tiles of ``segs * per`` steps."""
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
    return out.reshape(b, -1, d)[:, :s].to(x.dtype)


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

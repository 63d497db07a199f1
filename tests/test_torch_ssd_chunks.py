"""The chunk-parallel decomposition of the bf16 SSD kernel, on the CPU.

``csrc/ssd_scan.cu`` computes ``ref.ssd_chunked`` in bf16 chunk by chunk in
parallel: every chunk's state ``(B ∘ exp(cum_Q - cum_j) ∘ dt_j)ᵀ · x``, a
sequential pass ``h <- exp(total_c) h + state_c`` for each chunk's incoming
state, then every chunk's output ``(C·Bᵀ ∘ exp(cum_i - cum_j) ∘ dt_j) · x +
exp(cum_i) C · h_in + d_skip x``.  ``dt`` is folded into the score and the
state weights so that each product has one exact bf16 operand (x or C);
the f32 operand (the decayed score, the weighted B, the carried state) is
split into bf16 hi + lo.  ``_render`` is that decomposition in plain
PyTorch, with the split emulated by bf16 casts.

In f32 it must equal ``ref.ssd_chunked`` and the TPU kernel in interpret
mode within 1e-5 + 1e-5 relative, over the chunk widths the mixer gives
(1, 2, 17, 100, 128) in one chunk and several.  With the split, bf16
inputs must stay within 0.75 bf16 spacings of the f32 oracle (one rounding
of y costs 0.5); with the ``lo`` halves dropped they must not.  The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` holds it to
the same limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan import ssd as pallas_ssd
from repro_torch.kernels import ref

SPACINGS = 0.75


def _bf(t):
    return t.to(torch.bfloat16).float()


def _operand(t, mode):
    """An f32 operand as the kernel feeds it to the tensor cores: as is
    ("f32"), split into bf16 hi + lo ("hilo"), or hi alone ("hi")."""
    if mode == "f32":
        return t
    hi = _bf(t)
    return hi + _bf(t - hi) if mode == "hilo" else hi


def _render(x, dt, a_log, b_mat, c_mat, d_skip, chunk, mode="f32"):
    """The kernel's chunk-parallel decomposition of ``ref.ssd_chunked``."""
    f32 = torch.float32
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    xs = x.to(f32).reshape(b, nc, chunk, h, p)
    dts = dt.to(f32).reshape(b, nc, chunk, h)
    bm = b_mat.to(f32).reshape(b, nc, chunk, n)
    cm = c_mat.to(f32).reshape(b, nc, chunk, n)
    cum = torch.cumsum(dts * -torch.exp(a_log.to(f32)), 2)      # b c i h
    total = cum[:, :, -1]                                       # b c h
    # outputs from inside the chunk: the decay only on the causal triangle
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)
    diff = cum[:, :, :, None] - cum[:, :, None]                 # b c i j h
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[..., None]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    score = cb[..., None] * decay * dts[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", _operand(score, mode), xs)
    # every chunk's state, then the sequential pass for the incoming ones
    weighted = bm[..., None] * (torch.exp(total[:, :, None] - cum) * dts)[:, :, :, None]
    states = torch.einsum("bcjnh,bcjhp->bchnp", _operand(weighted, mode), xs)
    h_in = torch.zeros(b, h, n, p)
    carried = []
    for c in range(nc):
        carried.append(torch.einsum("bin,bhnp->bihp", cm[:, c],
                                    _operand(h_in, mode)))
        h_in = torch.exp(total[:, c])[..., None, None] * h_in + states[:, c]
    y = (y + torch.exp(cum)[..., None] * torch.stack(carried, 1)).reshape(x.shape)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype)


def _inputs(seed, b, s, h, p, n):
    """Inputs as the mamba2 mixer makes them (``chip_smoke.ssd_inputs``):
    silu'd x, B and C, dt the softplus of a normal around the reference's
    dt_bias init, a_log = log U(1, 16), unit skip."""
    rng = np.random.default_rng(seed)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), h))
    bias = dt0 + np.log(-np.expm1(-dt0))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    return (F.silu(t(rng.standard_normal((b, s, h, p)))),
            F.softplus(t(0.5 * rng.standard_normal((b, s, h)) + bias)),
            t(np.log(rng.uniform(1.0, 16.0, h))),
            F.silu(t(rng.standard_normal((b, s, n)))),
            F.silu(t(rng.standard_normal((b, s, n)))), torch.ones(h))


def _spacings(got, exp32):
    """Largest |got - exp32| in bf16 spacings at |exp32| (at 1/8 below
    1/8), as ``chip_smoke.bf16_spacings``."""
    mag = exp32.abs().clamp_min(0.125)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - exp32).abs() / spacing).max().item()


# (chunk, S): the widths ``models.ssm._ssd_chunk`` gives, in one chunk and
# in several
CASES = [(1, 1), (1, 37), (2, 2), (2, 130), (17, 17), (17, 51), (100, 100),
         (100, 300), (128, 128), (128, 256)]


@pytest.mark.parametrize("chunk,s", CASES)
def test_decomposition_matches_oracles_f32(chunk, s):
    """f32: the decomposition against ``ref.ssd_chunked`` and against the
    TPU kernel in interpret mode, within 1e-5 + 1e-5 relative."""
    args = _inputs(chunk * 1000 + s, 1, s, 2, 16, 32)
    got = _render(*args, chunk).numpy()
    np.testing.assert_allclose(
        got, ref.ssd_chunked(*args, chunk=chunk).numpy(), atol=1e-5, rtol=1e-5)
    jout = pallas_ssd(*(jnp.asarray(a.numpy()) for a in args), chunk=chunk,
                      interpret=True)
    np.testing.assert_allclose(got, np.asarray(jout), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk,s", CASES)
def test_emulated_split_within_bf16_limit(chunk, s):
    """bf16 inputs at mamba2's head and state widths (P 64, N 128): with
    every f32 operand split into hi + lo, within 0.75 bf16 spacings of the
    f32 oracle on the same (bf16) values."""
    x, dt, a_log, bm, cm, ds = _inputs(chunk + s, 1, s, 3, 64, 128)
    x, dt, bm, cm = (a.to(torch.bfloat16) for a in (x, dt, bm, cm))
    exp32 = ref.ssd_chunked(x.float(), dt.float(), a_log, bm.float(),
                            cm.float(), ds, chunk=chunk)
    got = _render(x, dt, a_log, bm, cm, ds, chunk, "hilo")
    assert got.dtype == torch.bfloat16
    assert _spacings(got, exp32) <= SPACINGS


@pytest.mark.parametrize("chunk,s", [(17, 51), (32, 32), (128, 256)])
def test_dropping_lo_breaks_the_bf16_limit(chunk, s):
    """The same rendering with the ``lo`` halves dropped (each f32 operand
    rounded once to bf16) misses the limit: the split is what holds it."""
    x, dt, a_log, bm, cm, ds = _inputs(chunk + s, 1, s, 3, 64, 128)
    x, dt, bm, cm = (a.to(torch.bfloat16) for a in (x, dt, bm, cm))
    exp32 = ref.ssd_chunked(x.float(), dt.float(), a_log, bm.float(),
                            cm.float(), ds, chunk=chunk)
    assert _spacings(_render(x, dt, a_log, bm, cm, ds, chunk, "hilo"),
                     exp32) <= SPACINGS
    assert _spacings(_render(x, dt, a_log, bm, cm, ds, chunk, "hi"),
                     exp32) > SPACINGS

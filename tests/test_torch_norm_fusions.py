"""The fused norm entry points of ``kernels/rmsnorm.py`` on the CPU.

``csrc/rmsnorm.cu`` runs one norm kernel in four forms: the norm, the
qk-norm pair (q and k, each with its own gain, in one launch), the residual
add with the norm after it (``s = x + y`` and its norm, both written) and
Mamba2's gated norm (``rmsnorm(y * silu(z))``).  Each form's plain version
is the expression the model ran before the fusion, so here each is held
against the JAX package's separate ops (``models.layers.rmsnorm``, ``+``,
``jax.nn.silu``) and the Pallas ``rmsnorm`` in interpret mode, in f32 and
bf16; the model's decode and chunk steps are held to call the fused forms
once per attention layer, MLP and SSD layer, as many norm launches as
``chip_smoke.expected_launches`` counts on the card, with the tokens of
the unfused norms.  The CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against these plain versions.

Tolerances: f32 2e-5 (the same f32 math summed in another order); bf16
two roundings of the largest |output| (2^-7 relative), as
``test_torch_kernels.py`` holds the norm.

The gated form's backward kernel computes the gate once an element
(``csrc/rmsnorm_bwd.cu``): ``e = exp(-z)``, ``d = 1 + e``, silu rounded
as ``z / d`` (the forward kernel's expression), ``sigmoid = 1 / d``, ``v``
once.  ``_gated_bwd_once`` is that arithmetic in plain PyTorch: against
``jax.vjp`` of the reference ``rmsnorm(y * silu(z))`` in f32 within 1e-5
of the largest |gradient| + 1e-5 relative; with bf16 inputs, each
gradient within one bf16 spacing (``chip_smoke.bwd_spacings``) of the f32
chain through ``jax.vjp`` of the reference norm at the forward's rounded
``v``, and the gain's within 1e-5 of its column's sum of |terms|; its
rounded silu (bf16) equal element for element to ``F.silu``, the
forward's plain route.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rk
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
EPS = 1e-6


def _pair(a, dt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _close(got_t, exp_j, dt):
    exp = np.asarray(exp_j.astype(jnp.float32))
    tol = 2e-5 if dt == "f32" else 2.0 ** -7 * max(1.0, np.abs(exp).max())
    np.testing.assert_allclose(got_t.float().numpy(), exp, atol=tol,
                               rtol=2e-5 if dt == "f32" else 2e-2)


def _jnorm(scale, x):
    return jlayers.rmsnorm({"scale": jnp.asarray(scale)}, x, EPS)


def _pnorm(scale, x):
    return pallas_rmsnorm(x, jnp.asarray(scale), eps=EPS, interpret=True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pair_matches_two_jax_norms(dt):
    """q (B,S,Hq,D) and k (B,S,Hkv,D), each with its own gain."""
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng.standard_normal((2, 3, 8, 32)), dt)
    kj, kt = _pair(rng.standard_normal((2, 3, 2, 32)), dt)
    qs = (0.5 * rng.standard_normal(32)).astype(np.float32)
    ks = (0.5 * rng.standard_normal(32)).astype(np.float32)
    gq, gk = rk.rmsnorm_pair_plain(qt, kt, torch.from_numpy(qs),
                                   torch.from_numpy(ks), EPS)
    assert gq.shape == qt.shape and gk.shape == kt.shape
    assert gq.dtype == gk.dtype == TDT[dt]
    for norm in (_jnorm, _pnorm):
        _close(gq, norm(qs, qj), dt)
        _close(gk, norm(ks, kj), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_add_norm_matches_jax_add_then_norm(dt):
    """s = x + y is the JAX sum in x's dtype, bit for bit; the norm of s
    matches the JAX norm of the JAX sum."""
    rng = np.random.default_rng(12)
    xj, xt = _pair(3.0 * rng.standard_normal((2, 5, 64)), dt)
    yj, yt = _pair(rng.standard_normal((2, 5, 64)), dt)
    scale = (0.5 * rng.standard_normal(64)).astype(np.float32)
    s, h = rk.add_rmsnorm_plain(xt, yt, torch.from_numpy(scale), EPS)
    sj = xj + yj
    assert s.dtype == h.dtype == TDT[dt]
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))
    for norm in (_jnorm, _pnorm):
        _close(h, norm(scale, sj), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gated_norm_matches_jax_silu_product_then_norm(dt):
    """Mamba2's ``rmsnorm(y * silu(z))`` against the JAX expression."""
    rng = np.random.default_rng(13)
    yj, yt = _pair(rng.standard_normal((2, 5, 96)), dt)
    zj, zt = _pair(2.0 * rng.standard_normal((2, 5, 96)), dt)
    scale = (0.5 * rng.standard_normal(96)).astype(np.float32)
    got = rk.gated_rmsnorm_plain(yt, zt, torch.from_numpy(scale), EPS)
    gated = yj * jax.nn.silu(zj)
    for norm in (_jnorm, _pnorm):
        _close(got, norm(scale, gated), dt)


def test_rows_reads_slices_in_place_and_copies_the_rest():
    """The wrappers read a slice of a wider projection through its row
    stride (Mamba2's z) and copy only what no single stride describes."""
    wide = torch.zeros(2, 5, 40)
    z = wide[..., 8:24]
    t, stride = rk._rows(z, 16)
    assert t.data_ptr() == z.data_ptr() and stride == 40
    t, stride = rk._rows(torch.zeros(3, 16), 16)
    assert stride == 16
    t, stride = rk._rows(wide[:, :, None, 8:24], 16)     # a size-1 axis
    assert t.data_ptr() == z.data_ptr() and stride == 40
    holes = wide[:, :4, 8:24]                            # rows 4 of 5 kept
    t, stride = rk._rows(holes, 16)
    assert t.is_contiguous() and t.data_ptr() != holes.data_ptr()
    assert stride == 16 and torch.equal(t, holes)
    t, stride = rk._rows(wide.transpose(1, 2)[..., :5], 5)
    assert t.is_contiguous() and stride == 5


def test_fused_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the
    CPU itself."""
    x = torch.zeros(2, 64)
    g = torch.zeros(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.rmsnorm_pair(x, x, g, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.add_rmsnorm(x, x, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.gated_rmsnorm(x, x, g)
    before = ops.kernel_launches()["rmsnorm"]
    s, h = ops.add_rmsnorm(x + 1.0, x, g)
    assert torch.equal(s, x + 1.0) and h.shape == x.shape
    assert ops.kernel_launches()["rmsnorm"] == before


# ------------------------------------------------ the model's call sites
ARCHS = ["qwen3-4b", "mamba2-780m", "recurrentgemma-9b"]


def _count(monkeypatch, calls):
    """Count the calls of each norm entry point in ``ops`` (each is one
    launch on the card)."""
    for name in ("rmsnorm", "rmsnorm_pair", "add_rmsnorm", "gated_rmsnorm"):
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, wrapped)


def _unfuse(monkeypatch):
    """The model's norms as it ran them before the fusion: two norms for
    the qk pair, the add then the norm, the gate then the norm."""
    norm = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm_pair", lambda q, k, qs, ks, eps: (
        norm(q, qs, eps), norm(k, ks, eps)))
    monkeypatch.setattr(ops, "add_rmsnorm", lambda x, y, sc, eps: (
        x + y, norm(x + y, sc, eps)))
    monkeypatch.setattr(ops, "gated_rmsnorm", lambda y, z, sc, eps: norm(
        y * torch.nn.functional.silu(z), sc, eps))


def _greedy(tp, tc, prompt, steps):
    """A chunk of the prompt, then greedy decode steps: the tokens and the
    last logits."""
    cache = TM.init_cache(tc, 1, 32, "cpu")
    tl, cache = TM.prefill_chunk(tp, cache, torch.from_numpy(prompt)[None]
                                 .long(), 0, tc)
    toks = [int(torch.argmax(tl[0, -1]))]
    for i in range(steps):
        tl, cache = TM.decode_step(tp, cache, torch.tensor([[toks[-1]]]),
                                   len(prompt) + i, tc)
        toks.append(int(torch.argmax(tl[0, -1])))
    return toks, tl


@pytest.mark.parametrize("arch", ARCHS)
def test_model_calls_the_fused_forms_with_tokens_unchanged(monkeypatch,
                                                           arch):
    """A chunk of a smoke-config prompt, then greedy decode steps: each
    step calls ``rmsnorm_pair`` once per attention layer, ``add_rmsnorm``
    once per MLP, ``gated_rmsnorm`` once per SSD layer and ``rmsnorm``
    once per layer plus the final norm, which is the count
    ``chip_smoke.expected_launches`` holds the card to; and the greedy
    tokens and logits equal those of the unfused norms (``test_torch_model``
    holds the same steps to the JAX package's tokens)."""
    torch.set_num_threads(2)
    tc = get_smoke_config(arch).replace(dtype=torch.float32)
    tp = TM.init_model(tc, 0, "cpu")
    kinds = tc.layer_kinds()
    per_step = {"rmsnorm": len(kinds) + 1,
                "rmsnorm_pair": kinds.count("attn") * tc.use_qk_norm,
                "add_rmsnorm": len(kinds) if tc.d_ff > 0 else 0,
                "gated_rmsnorm": kinds.count("ssm")}
    per_step = {k: v for k, v in per_step.items() if v}
    prompt = np.random.default_rng(7).integers(2, tc.vocab_size, size=(12,))
    steps = 3
    with monkeypatch.context() as m:
        _unfuse(m)
        want, want_logits = _greedy(tp, tc, prompt, steps)
    calls = {}
    _count(monkeypatch, calls)
    got, logits = _greedy(tp, tc, prompt, steps)
    assert got == want and torch.equal(logits, want_logits)
    assert calls == {k: v * (1 + steps) for k, v in per_step.items()}
    want_launches = chip_smoke.expected_launches(tc, steps, 1, 0)["rmsnorm"]
    assert sum(calls.values()) == want_launches


def _gated_bwd_once(y, z, scale, dout, eps=EPS):
    """The gated backward kernel's arithmetic, the gate computed once an
    element: (dy, dz in y's dtype, dscale f32, the rounded silu)."""
    t = y.dtype
    yf, zf, gf = y.float(), z.float(), dout.float()
    d = 1.0 + torch.exp(-zf)
    silu = (zf / d).to(t).float()
    sig = 1.0 / d
    v = (yf * silu).to(t).float()
    w = 1.0 + scale.float()
    r = torch.rsqrt(v.square().mean(-1, keepdim=True) + eps)
    coef = r * r * (gf * w * v).mean(-1, keepdim=True)
    dv = r * (gf * w - v * coef)
    dz = dv * yf * (sig * (1.0 + zf * (1.0 - sig)))
    dscale = (gf * (v * r)).reshape(-1, v.shape[-1]).sum(0)
    return (dv * silu).to(t), dz.to(t), dscale, silu


def _gated_inputs(seed, rows, d, dt):
    rng = np.random.default_rng(seed)
    y, z, dout = (rng.standard_normal((rows, d)).astype(np.float32)
                  for _ in range(3))
    z[0, :4] = [-30.0, 30.0, 0.0, -1e-3]       # far tails, zero, near zero
    scale = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(TDT[dt]) for a in (y, z, dout)] + \
        [torch.from_numpy(scale)]


GATED_WIDTHS = [64, 999, 1536, 3072, 4096]


@pytest.mark.parametrize("d", GATED_WIDTHS)
def test_gated_bwd_gate_once_matches_jax_vjp_f32(d):
    y, z, dout, scale = _gated_inputs(d, 6, d, "f32")

    def f(y_, z_, s_):                    # as repro.models.ssm gates its norm
        return jlayers.rmsnorm({"scale": s_}, y_ * jax.nn.silu(z_), EPS)
    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (y, z, scale)))
    want = vjp(jnp.asarray(dout.numpy()))
    got = _gated_bwd_once(y, z, scale, dout)
    for name, g, w in zip(("dy", "dz", "dscale"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("d", GATED_WIDTHS)
def test_gated_bwd_gate_once_bf16_within_one_spacing(d):
    """bf16 inputs: the f32 chain rule through ``jax.vjp`` of the reference
    norm at the forward's v (silu rounded, then the product rounded)."""
    y, z, dout, scale = _gated_inputs(100 + d, 6, d, "bf16")
    got = _gated_bwd_once(y, z, scale, dout)
    silu = got[3]
    v = (y.float() * silu).to(torch.bfloat16).float()
    _, vjp = jax.vjp(lambda v_, s_: jlayers.rmsnorm({"scale": s_}, v_, EPS),
                     jnp.asarray(v.numpy()), jnp.asarray(scale.numpy()))
    dv, dscale = (torch.from_numpy(np.array(a)) for a in
                  vjp(jnp.asarray(dout.float().numpy())))
    zf = z.double()
    sig = torch.sigmoid(zf)
    want = (dv.double() * silu.double(),
            dv.double() * y.double() * (sig * (1.0 + zf * (1.0 - sig))))
    for name, g, w in zip(("dy", "dz"), got, want):
        assert g.dtype == torch.bfloat16, name
        assert chip_smoke.bwd_spacings(g, w.float()) <= 1.0, name
    vr = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + EPS)
    terms = (dout.float() * vr).abs().sum(0)
    assert ((got[2] - dscale).abs() <= 1e-5 * terms).all()


def test_gated_bwd_silu_is_the_forwards():
    """bf16, the training dtype: the rounded silu of the gate-once
    arithmetic equals ``F.silu``'s, element for element, the factor the
    plain forward multiplies y by.  (In f32 ``F.silu`` differs from ``z /
    (1 + exp(-z))`` in the last bit now and then; the kernels, forward and
    backward, both take the latter.)"""
    z = torch.from_numpy(np.concatenate([
        np.random.default_rng(5).standard_normal(1 << 16) * 4,
        np.linspace(-90, 90, 4001)]).astype(np.float32)).to(torch.bfloat16)
    one = torch.ones_like(z)
    silu = _gated_bwd_once(one, z, torch.zeros(z.shape[-1]), one)[3]
    assert torch.equal(silu.to(torch.bfloat16), torch.nn.functional.silu(z))

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

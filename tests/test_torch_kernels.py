"""The port's kernel plain versions against the JAX package's oracles and
Pallas kernels (``interpret=True``), on the CPU, with the same inputs drawn
from numpy seeds; plus device dispatch, the launch counters, the package's
import hygiene and the sampler's Philox stream.

The CUDA/Triton kernels themselves run only on the card: ``chip_smoke.py``
holds each against the plain version tested here.

Tolerances: f32 cases compare the same f32 math summed in another order,
so 2e-5 absolute on O(1) outputs (the JAX package's own Pallas-vs-oracle
bound).  bf16 cases round inputs and outputs to bf16 (2^-8 relative), so
2e-2 absolute.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rk
from repro_torch.serving import sampling as tsamp

REPO = os.path.join(os.path.dirname(__file__), "..")
TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _close(got_t, exp_j, dt, mask=None):
    got = got_t.float().numpy()
    exp = np.asarray(exp_j.astype(jnp.float32))
    if mask is not None:
        got, exp = got[mask], exp[mask]
    np.testing.assert_allclose(got, exp, atol=TOL[dt], rtol=TOL[dt])


def _ring_pos(rng, b, n, lens, holes=0.0):
    """Ring pos planes after writing positions 0..len-1 at slot p % n."""
    pos = np.full((b, n), -1, np.int32)
    for i, ln in enumerate(lens):
        p = np.arange(max(0, ln - n), ln)
        pos[i, p % n] = p
    if holes:
        pos[rng.random((b, n)) < holes] = -1
    return pos


# -------------------------------------------------------------------- decode
DECODE_CASES = [
    # b, n, hq, hkv, d, window, softcap, dtype
    (4, 64, 8, 2, 16, 0, 0.0, "f32"),
    (3, 48, 4, 4, 32, 16, 0.0, "f32"),
    (4, 64, 8, 2, 16, 0, 30.0, "f32"),
    (4, 64, 8, 1, 16, 8, 0.0, "bf16"),
]


@pytest.mark.parametrize("b,n,hq,hkv,d,window,softcap,dt", DECODE_CASES)
def test_decode_plain_matches_reference_and_pallas(b, n, hq, hkv, d, window,
                                                   softcap, dt):
    """Without ``pos``: per-lane cache_len masking, against
    ``ref.decode_mha_reference`` and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((b, 1, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((b, n, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((b, n, hkv, d)), dt)
    lens = rng.integers(1, n + 1, size=b).astype(np.int32)
    scale = d ** -0.5
    got = dk.decode_attention_plain(qt, kt, vt, cache_len=torch.from_numpy(lens),
                                    window=window, scale=scale,
                                    softcap=softcap)
    kw = dict(cache_len=jnp.asarray(lens), window=window, scale=scale,
              softcap=softcap)
    _close(got, jref.decode_mha_reference(qj, kj, vj, **kw), dt)
    _close(got, pallas_decode(qj, kj, vj, block_k=16, interpret=True, **kw),
           dt)


@pytest.mark.parametrize("window,softcap,dt,holes",
                         [(0, 0.0, "f32", 0.0), (16, 0.0, "f32", 0.2),
                          (0, 30.0, "f32", 0.2), (16, 0.0, "bf16", 0.0)])
def test_decode_plain_with_pos_matches_ring_site(window, softcap, dt, holes):
    """With ``pos``: the ring decode site's mask (``blocks.py:200-205``) and
    ``ref.decode_mha_masked``, over wrapped rings with empty slots.  Lanes
    with no visible slot are discarded by the engine and not compared."""
    rng = np.random.default_rng(1)
    b, n, hq, hkv, d = 5, 32, 8, 2, 16
    qj, qt = _pair(rng.standard_normal((b, 1, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((b, n, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((b, n, hkv, d)), dt)
    lens = np.array([1, 5, 32, 47, 90], np.int32)       # 47, 90 wrap
    pos = _ring_pos(rng, b, n, lens, holes)
    idx = lens - 1
    valid = (pos >= 0)
    if window:
        valid &= pos > idx[:, None] - window
    exp = jref.decode_mha_masked(qj, kj, vj, valid_mask=jnp.asarray(valid),
                                 scale=d ** -0.5, softcap=softcap)
    got = dk.decode_attention_plain(
        qt, kt, vt, cache_len=torch.from_numpy(lens),
        pos=torch.from_numpy(pos), window=window, scale=d ** -0.5,
        softcap=softcap)
    _close(got, exp, dt, mask=valid.any(1))


# --------------------------------------------------------------------- flash
FLASH_CASES = [
    # b, s, hq, hkv, d, window, softcap, dtype
    (2, 40, 4, 2, 16, 0, 0.0, "f32"),
    (1, 33, 8, 1, 32, 8, 0.0, "f32"),
    (2, 24, 4, 4, 16, 0, 30.0, "f32"),
    (1, 32, 4, 2, 16, 16, 0.0, "bf16"),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,softcap,dt", FLASH_CASES)
def test_flash_plain_whole_prompt_matches_reference_and_pallas(
        b, s, hq, hkv, d, window, softcap, dt):
    """q_pos = k_pos = arange(S): ``ref.mha_reference`` and the Pallas
    flash kernel in interpret mode."""
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((b, s, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)), dt)
    ar = torch.arange(s, dtype=torch.int32)
    got = fk.flash_attention_plain(qt, kt, vt, q_pos=ar, k_pos=ar, causal=True,
                                   window=window, scale=d ** -0.5,
                                   softcap=softcap)
    kw = dict(causal=True, window=window, scale=d ** -0.5, softcap=softcap)
    _close(got, jref.mha_reference(qj, kj, vj, **kw), dt)
    _close(got, pallas_flash(qj, kj, vj, block_q=16, block_k=16,
                             interpret=True, **kw), dt)


@pytest.mark.parametrize("start,window,dt", [(0, 0, "f32"), (20, 0, "f32"),
                                             (45, 16, "f32"), (45, 0, "bf16")])
def test_flash_plain_chunk_matches_cache_masked(start, window, dt):
    """Chunked prefill: q_pos = start + arange(C), k_pos = [ring.pos ‖
    q_pos], against ``ref.mha_cache_masked`` with the (B, C, n+C) mask
    ``blocks.py:297-304`` builds."""
    rng = np.random.default_rng(3)
    b, c, n, hq, hkv, d = 2, 8, 32, 4, 2, 16
    qj, qt = _pair(rng.standard_normal((b, c, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((b, n + c, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((b, n + c, hkv, d)), dt)
    ring = _ring_pos(rng, b, n, [start] * b)
    positions = np.arange(start, start + c, dtype=np.int32)
    pos_cat = np.concatenate([ring, np.broadcast_to(positions, (b, c))], 1)
    m = (pos_cat[:, None, :] >= 0) & (pos_cat[:, None, :] <= positions[None, :, None])
    if window:
        m &= pos_cat[:, None, :] > positions[None, :, None] - window
    exp = jref.mha_cache_masked(qj, kj, vj, mask=jnp.asarray(m),
                                scale=d ** -0.5)
    got = fk.flash_attention_plain(qt, kt, vt, q_pos=torch.from_numpy(positions),
                                   k_pos=torch.from_numpy(pos_cat),
                                   causal=True, window=window, scale=d ** -0.5)
    _close(got, exp, dt)


# ------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape,dt", [((8, 2560), "f32"), ((8, 32, 128), "f32"),
                                      ((8, 2560), "bf16"),
                                      ((8, 32, 128), "bf16")])
def test_rmsnorm_plain_matches_layers_and_pallas(shape, dt):
    """Both widths the model runs (d_model rows, headwise qk-norm) against
    ``models/layers.py::rmsnorm`` and the Pallas kernel in interpret mode.
    bf16 outputs reach several units: the tolerance is two bf16 roundings
    of the largest |output| there."""
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal(shape), dt)
    scale = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    got = rk.rmsnorm_plain(xt, torch.from_numpy(scale), 1e-6)
    exp = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    tol = TOL[dt] if dt == "f32" else \
        2.0 ** -7 * max(1.0, float(jnp.abs(exp.astype(jnp.float32)).max()))
    for e in (exp, pallas_rmsnorm(xj, jnp.asarray(scale), eps=1e-6,
                                  interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(e.astype(jnp.float32)),
                                   atol=tol, rtol=TOL[dt])


# ------------------------------------------------------------ dispatch/counts
def test_cpu_tensors_take_plain_versions_without_counting():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    before = ops.kernel_launches()
    cl = torch.tensor([3, 8], dtype=torch.int32)
    out = ops.decode_attention(q, k, k, cache_len=cl, scale=0.25)
    exp = dk.decode_attention_plain(q, k, k, cache_len=cl, scale=0.25)
    assert torch.equal(out, exp)
    x = torch.ones(3, 16)
    assert torch.equal(ops.rmsnorm(x, torch.zeros(16)),
                       rk.rmsnorm_plain(x, torch.zeros(16)))
    ar = torch.arange(8, dtype=torch.int32)
    qq = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
    assert torch.equal(
        ops.flash_attention(qq, k, k, q_pos=ar, k_pos=ar, scale=0.25),
        fk.flash_attention_plain(qq, k, k, q_pos=ar, k_pos=ar, scale=0.25))
    assert ops.kernel_launches() == before       # plain calls never count
    ops.reset_kernel_launches()
    assert ops.kernel_launches() == {"decode_attention": 0,
                                     "flash_attention": 0, "rmsnorm": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the
    CPU itself."""
    q = torch.zeros(1, 1, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    cl = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dk.decode_attention(q, k, k, cache_len=cl, scale=0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        fk.flash_attention(q, k, k, q_pos=[0], k_pos=list(range(8)),
                           scale=0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.rmsnorm(torch.zeros(2, 64), torch.zeros(64))


# ------------------------------------------------------------------- sampler
def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors)."""
    cases = [
        ((0, 0), (0, 0, 0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff, 0xffffffff), (0xffffffff,) * 4,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0xa4093822, 0x299f31d0),
         (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for key, ctr, want in cases:
        assert tuple(int(w) for w in tsamp.philox4x32(key, ctr)) == want
    u = tsamp.philox_uniform(np.arange(1000), np.zeros(1000))
    assert 0.0 <= u.min() and u.max() < 1.0 and abs(u.mean() - 0.5) < 0.05


# ------------------------------------------------------------ import hygiene
def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke, import without pulling
    ``jax`` or any ``repro``/``repro.*`` module into the process."""
    code = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": len(names), "bad": bad}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(REPO, "src"), REPO],
        capture_output=True, text=True, timeout=120, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 25
    assert res["bad"] == []

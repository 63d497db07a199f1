"""The flash kernel's two key sources and both attention kernels' key
splits, on the CPU.

Chunked prefill hands the flash kernel the ring (``k_cache``, ``v_cache``,
``cache_pos``) beside the chunk's own K/V instead of concatenating them.
The plain version takes the same arguments: it must equal the call on the
concatenated keys and the JAX package's ``ref.mha_cache_masked`` on the
same numpy inputs, over an empty, a partly filled and a wrapped ring with
holes.  The model's chunked-prefill call site must pass the ring itself.
The key-split choice of both kernels, with the card's 132 SMs, must give
grids within Hopper's limits at every serving shape.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
these plain versions there.  Tolerances as in ``test_torch_kernels.py``:
f32 2e-5 (the same f32 math in another order), bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pk
from repro_torch.models import model as TM

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# Hopper (H100): the largest grid y and z
GRID_YZ = 65535


def _pair(a, dt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _ring_pos(rng, b, n, start, holes):
    """Ring pos planes after writing positions 0..start-1 at slot p % n,
    a share ``holes`` of slots then emptied (-1)."""
    pos = np.full((b, n), -1, np.int32)
    p = np.arange(max(0, start - n), start)
    pos[:, p % n] = p
    pos[rng.random((b, n)) < holes] = -1
    return pos


RINGS = {"empty": (0, 0.0), "partial": (20, 0.0), "wrapped+holes": (75, 0.2)}


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("c", [1, 32])
@pytest.mark.parametrize("window,softcap,dt", [(0, 0.0, "f32"),
                                               (16, 0.0, "f32"),
                                               (0, 30.0, "f32"),
                                               (16, 30.0, "bf16")])
def test_flash_plain_two_sources_match_concatenation_and_jax(ring, c, window,
                                                             softcap, dt):
    rng = np.random.default_rng(11)
    b, n, hq, hkv, d = 2, 32, 8, 2, 16
    start, holes = RINGS[ring]
    qj, qt = _pair(rng.standard_normal((b, c, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((b, n + c, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((b, n + c, hkv, d)), dt)
    cpos = _ring_pos(rng, b, n, start, holes)
    qpos = np.arange(start, start + c, dtype=np.int32)
    kw = dict(q_pos=torch.from_numpy(qpos), causal=True, window=window,
              scale=d ** -0.5, softcap=softcap)
    two = fk.flash_attention_plain(
        qt, kt[:, n:], vt[:, n:], k_pos=torch.from_numpy(qpos),
        k_cache=kt[:, :n], v_cache=vt[:, :n],
        cache_pos=torch.from_numpy(cpos), **kw)
    kpos = np.concatenate([cpos, np.broadcast_to(qpos, (b, c))], 1)
    one = fk.flash_attention_plain(qt, kt, vt, k_pos=torch.from_numpy(kpos),
                                   **kw)
    assert torch.equal(two, one)
    m = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    if window:
        m &= kpos[:, None, :] > qpos[None, :, None] - window
    exp = jref.mha_cache_masked(qj, kj, vj, mask=jnp.asarray(m),
                                scale=d ** -0.5, softcap=softcap)
    np.testing.assert_allclose(two.float().numpy(),
                               np.asarray(exp.astype(jnp.float32)),
                               atol=TOL[dt], rtol=TOL[dt])


def test_ops_and_wrapper_take_the_ring_arguments():
    """``ops.flash_attention`` hands the ring to the plain version on the
    CPU, uncounted; the kernel wrapper refuses CPU tensors with the ring
    arguments too."""
    rng = np.random.default_rng(12)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, kc = f(1, 4, 4, 64), f(1, 4, 2, 64), f(1, 8, 2, 64)
    cp = torch.arange(8, dtype=torch.int32)[None]
    qp = torch.arange(8, 12, dtype=torch.int32)
    kw = dict(q_pos=qp, k_pos=qp, scale=0.125, k_cache=kc, v_cache=kc,
              cache_pos=cp)
    before = ops.kernel_launches()
    assert torch.equal(ops.flash_attention(q, k, k, **kw),
                       fk.flash_attention_plain(q, k, k, **kw))
    assert ops.kernel_launches() == before
    with pytest.raises(RuntimeError, match="CUDA"):
        fk.flash_attention(q, k, k, **kw)


@pytest.mark.parametrize("arch,start,c", [("qwen3-4b", 0, 5),
                                          ("qwen3-4b", 40, 8),
                                          ("recurrentgemma-9b", 40, 8)])
def test_prefill_chunk_passes_the_ring_not_a_concatenation(monkeypatch, arch,
                                                           start, c):
    """Every attention layer of ``prefill_chunk`` gives the flash entry
    point the chunk's own C keys and the layer's ring tensors themselves,
    read before the chunk is scattered into them; each layer's attention
    equals the call on the concatenated keys."""
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    params = TM.init_model(cfg, seed=3, device="cpu")
    cap = 64
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab_size, size=(1, start + c))).long()
    cache = TM.init_cache(cfg, 1, cap, "cpu")
    if start:
        _, cache = TM.prefill_chunk(params, cache, toks[:, :start], 0, cfg)
    rings = {id(layer["k"]): layer for layer in cache if "k" in layer}
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, *, k_pos, k_cache=None, v_cache=None, cache_pos=None,
            **kw):
        layer = rings[id(k_cache)]
        assert v_cache is layer["v"] and cache_pos is layer["pos"]
        assert k.shape[1] == v.shape[1] == k_pos.shape[-1] == c
        seen.append(cache_pos.clone())
        out = real(q, k, v, k_pos=k_pos, k_cache=k_cache, v_cache=v_cache,
                   cache_pos=cache_pos, **kw)
        kp = torch.cat([cache_pos, k_pos.expand(q.shape[0], c)], 1)
        assert torch.equal(out, real(q, torch.cat([k_cache, k], 1),
                                     torch.cat([v_cache, v], 1), k_pos=kp,
                                     **kw))
        return out

    before = [layer["pos"].clone() for layer in rings.values()]
    monkeypatch.setattr(ops, "flash_attention", spy)
    TM.prefill_chunk(params, cache, toks[:, start:], start, cfg)
    assert len(seen) == cfg.layer_kinds().count("attn") == len(rings)
    for got, was in zip(seen, before):
        assert torch.equal(got, was)          # read before the scatter


SERVING = {
    # arch: (Hq, Hkv, head_dim, ring slots)
    "qwen3-4b": (32, 8, 128, 2048),
    "recurrentgemma-9b": (16, 1, 256, 2048),
    "mixtral-8x22b": (48, 8, 128, 4096),    # GQA ratio 6, window 4096
    "arctic-480b": (56, 8, 128, 2048),      # GQA ratio 7
}


@pytest.mark.parametrize("arch", list(SERVING))
def test_launch_geometry_fits_hopper_at_serving_shapes(monkeypatch, arch):
    """auto_splits (132 SMs) at every chunk width 1-32 over a ring, whole
    prompts up to 4096 and decode at 1-8 lanes: the split count within its
    range, the grids it gives within Hopper's limits, no split over more
    key tiles than the kernel's live-tile mask holds, and one split for a
    prompt whose row tiles alone fill the SMs.  (Each kernel's shared
    memory is held within the SM's at compile time, in its .cu file.)
    Paged decode at 1-8 lanes over tables of 2048 and 4096 positions in
    pages of 8 and 16: the same, and its table slice within what the
    kernel's shared memory holds."""
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    hq, hkv, d, n = SERVING[arch]
    cfg = get_config(arch)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (hq, hkv, d)
    rep = hq // hkv

    def flash_fits(b, s, t):
        sp = fk.auto_splits(b, s, hq, hkv, t, "cuda")
        assert 1 <= sp <= 32
        # bf16 grid (packed-row tiles, KV heads, rows x splits); the f32
        # grid has one y per query head
        x, z = -(-s * rep // fk._BM), b * sp
        assert 1 <= x < 2 ** 31 and hq <= GRID_YZ and 1 <= z <= GRID_YZ
        assert -(-t // (32 * sp)) <= fk._MAX_TILES
        return sp, x

    for c in range(1, 33):
        flash_fits(1, c, n + c)
    for s in (1, 17, 512, 2304, 4096):
        sp, x = flash_fits(1, s, s)
        if x * hkv >= 132:
            assert sp == 1
    for b in range(1, 9):
        sp = dk.auto_splits(b, hkv, n, "cuda")
        assert 1 <= sp <= 32 and b <= GRID_YZ and sp <= GRID_YZ
        # paged decode: grid (KV heads, lanes, page ranges), each block
        # holding its range's slice of the table in shared memory (the
        # .cu file holds the block's layout with MAX_TABLE_SLICE entries
        # within the SM's shared memory); tables of the ring's capacity
        # and of 4096 positions, in pages of 8 and 16
        for page in (8, 16):
            for maxp in (n // page, 4096 // page):
                sp = pk.auto_splits(b, hkv, maxp, page, "cuda")
                assert 1 <= sp <= 32 and b <= GRID_YZ and sp <= GRID_YZ
                assert 1 <= -(-maxp // sp) <= pk.MAX_TABLE_SLICE
                # every range at least 256 positions, or one range
                assert sp == 1 or -(-maxp // sp) * page >= 256
                # about two waves of blocks on the 132 SMs, no more
                assert sp == 1 or hkv * b * (sp - 1) < 2 * 132


@pytest.mark.parametrize("rep", [3, 5, 6, 7])
def test_decode_wrappers_accept_every_ratio_and_refuse_a_non_divisor(rep):
    """The ring and paged decode wrappers' shape checks take any GQA ratio
    from 1 to 16 (mixtral's 6, arctic's 7), at each head_dim, and still
    refuse query heads that are not a multiple of the KV heads, and a
    ratio over 16."""
    hkv, b, n, page, maxp = 2, 2, 32, 8, 4

    def calls(hq, d):
        q = torch.zeros((b, 1, hq, d))
        cache = torch.zeros((b, n, hkv, d))
        pool = torch.zeros((b * maxp + 1, page, hkv, d))
        cl = torch.ones(b, dtype=torch.int32)
        pos = torch.zeros((b, n), dtype=torch.int32)
        ppos = torch.zeros(pool.shape[:2], dtype=torch.int32)
        tables = torch.zeros((b, maxp), dtype=torch.int32)
        return (lambda: dk._check(q, cache, cache, cl, pos),
                lambda: pk._check(q, pool, pool, ppos, tables, cl))

    for d in (64, 128, 256):
        for check in calls(hkv * rep, d):
            check()
        for hq in (hkv * rep + 1, hkv * 17):
            for check in calls(hq, d):
                with pytest.raises(ValueError, match="unsupported"):
                    check()

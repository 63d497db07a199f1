"""Flash attention forward with position masks (prefill and chunked prefill).

Kernel: ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``), replacing
the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``).  ``flash_attention`` launches it on CUDA tensors;
``flash_attention_plain`` is the same function in plain PyTorch, which the
CPU path runs and the kernel is held against.

It is bound by the bytes of q, K, V and out at the main path's shapes.  In
bf16 a block owns 64 *packed rows* of one KV head (packed row r is query
r // rep of query head ``kh * rep + r % rep``), so every K/V tile is read
once per row tile, not per query head (at a ratio that does not divide 64,
such as mixtral's 6 or arctic's 7, a tile ends part way through a query's
heads); Q·Kᵀ and P·V run on the tensor cores (``mma.sync``,
f32 accumulation), with P split into ``hi = bf16(P)`` and ``lo = bf16(P -
hi)`` so that it keeps about 16 mantissa bits of the oracle's f32 P; K/V
tiles of 64 keys (32 at D 256) stream through shared-memory stages by
``cp.async``, and a tile no query of the block can see is never requested.
A chunk has few row tiles, so its keys are also split over blocks, whose
partial softmax states a second kernel merges.  f32 inputs take a
CUDA-core body of the same function, selected by dtype (the identity
checks run f32); both routes launch or raise.

Key j of row b is visible to query i when ``k_pos[b, j] >= 0``, and
``k_pos <= q_pos`` when causal, and ``k_pos > q_pos - window`` with a
window.  Whole-prompt prefill passes ``q_pos = k_pos = arange(S)``
(``ref.mha_reference``).  Chunked prefill passes the ring through
``k_cache``, ``v_cache`` and ``cache_pos``: its slots are keys ``[0, n)``,
ahead of the chunk's own ``k``, ``v``, ``k_pos`` (``ref.mha_cache_masked``
over ``[ring ‖ chunk]``), so the caller never concatenates them.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Launch geometry, as csrc/flash_attention.cu has it: a bf16 block owns
# _BM packed rows; a split walks at most _MAX_TILES key tiles (its live-tile
# mask), of 32 keys at the smallest.  The kernel's shared-memory layout
# stays in the .cu file, checked there at compile time.
_BM = 64
_MAX_TILES = 4096


def _counted() -> None:
    global launches
    with _count_lock:
        launches += 1


def _positions(p, b: int, length: int, device) -> torch.Tensor:
    """(L,) or (B, L) positions -> contiguous (B, L) int32 on ``device``."""
    p = torch.as_tensor(p, device=device).to(torch.int32)
    if p.dim() == 1:
        p = p[None].expand(b, length)
    if p.shape != (b, length):
        raise ValueError(f"flash_attention: positions {tuple(p.shape)} "
                         f"for ({b}, {length})")
    return p.contiguous()


def auto_splits(b: int, s: int, hq: int, hkv: int, t: int, device) -> int:
    """Key ranges per (row tile, KV head): about two waves of blocks on
    the card's SMs when the row tiles alone fill less than one (a chunk has
    few; a whole prompt has plenty and runs one split), at least 256 keys
    per range, at most 32; and enough ranges that none holds more than
    ``_MAX_TILES`` key tiles."""
    sms = build.sm_count(torch.device(device).index or 0)
    blocks = -(-s * (hq // hkv) // _BM) * hkv * b
    want = 1 if blocks >= sms else -(-2 * sms // blocks)
    fit = -(-t // (32 * _MAX_TILES))     # 32: the smallest key tile
    return max(fit, min(want, -(-t // 256), 32, 65535 // b))


def _check(q, k, v, k_cache, v_cache, cache_pos):
    b, s, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[2]
    if hq % hkv or d not in (64, 128, 256):
        raise ValueError(f"flash_attention: unsupported heads/head_dim "
                         f"{hq}/{hkv}/{d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    ring = () if k_cache is None else (k_cache, v_cache)
    if k_cache is not None:
        n = k_cache.shape[1]
        if k_cache.dim() != 4 or v_cache is None \
                or v_cache.shape != k_cache.shape \
                or (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) \
                != (b, hkv, d) or cache_pos is None \
                or cache_pos.shape != (b, n) or cache_pos.dtype != torch.int32:
            raise ValueError("flash_attention: k_cache/v_cache must be "
                             f"(B, n, {hkv}, {d}) and cache_pos (B, n) int32")
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError("flash_attention: the ring's dtype differs")
    for t in (k, v) + ring + (() if cache_pos is None else (cache_pos,)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous "
                             "and on one device")
    for t in (q, k, v) + ring:
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v and the ring must be "
                             "16-byte aligned (16-byte copies)")


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale,
                    softcap=0.0, splits=None, k_cache=None, v_cache=None,
                    cache_pos=None):
    """Launch the Hopper kernel.  q: (B, S, Hq, D); k, v: (B, C, Hkv, D);
    ``q_pos`` (S,) or (B, S), ``k_pos`` (C,) or (B, C) integer positions
    (-1 = empty key slot).  With a ring, ``k_cache``/``v_cache`` (B, n,
    Hkv, D) and ``cache_pos`` (B, n) int32 are keys [0, n), ahead of the
    chunk's.  Returns (B, S, Hq, D) in q's dtype.  ``splits`` is the number
    of key ranges per row tile, ``auto_splits`` by default; 1 runs a single
    pass with no combine."""
    if q.device.type != "cuda":
        raise RuntimeError("flash_attention kernel needs CUDA tensors; "
                           "use flash_attention_plain on the CPU")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, k_cache, v_cache, cache_pos)
    b, s, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    n = 0 if k_cache is None else k_cache.shape[1]
    qp = _positions(q_pos, b, s, q.device)
    kp = _positions(k_pos, b, c, q.device)
    if splits is None:
        splits = auto_splits(b, s, hq, hkv, n + c, q.device)
    out = torch.empty_like(q)
    # per (batch row, query row, head, split): (max, sum) and a D-wide
    # accumulator
    work = (torch.empty(b * s * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = build.library("flash_attention", _ARGTYPES).flash_attention_launch
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_cache),
                 ptr(v_cache), qp.data_ptr(), kp.data_ptr(), ptr(cache_pos),
                 out.data_ptr(), ptr(work), b, s, c, n, hq, hkv, d,
                 _DTYPES[q.dtype], int(splits), int(bool(causal)),
                 int(window), float(scale), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _counted()
    return out


def flash_attention_plain(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                          scale, softcap=0.0, k_cache=None, v_cache=None,
                          cache_pos=None):
    """The same function in plain PyTorch (the CPU path and the oracle):
    puts the ring's keys ahead of the chunk's, builds the (B, S, T) mask
    from the positions and runs ``ref.mha_cache_masked`` (f32 softmax)."""
    b, s = q.shape[0], q.shape[1]
    kp = _positions(k_pos, b, k.shape[1], q.device)
    if k_cache is not None:
        k = torch.cat([k_cache, k], dim=1)
        v = torch.cat([v_cache, v], dim=1)
        kp = torch.cat([_positions(cache_pos, b, k_cache.shape[1], q.device),
                        kp], dim=1)
    qp = _positions(q_pos, b, s, q.device)[:, :, None]
    kp = kp[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return ref.mha_cache_masked(q, k, v, mask=m, scale=scale, softcap=softcap)

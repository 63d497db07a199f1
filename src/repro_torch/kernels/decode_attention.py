"""Decode attention: one query token per lane over its KV cache.

Kernel: ``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``), replacing
the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``
(``_decode_kernel``).  It is bound by the bytes of K and V it must read;
the source's header says how its design meets that (flash-decoding: each
lane's slots are split over several blocks, whose partial softmax states a
second kernel merges).  ``decode_attention`` launches it on CUDA tensors;
``decode_attention_plain`` is the same function in plain PyTorch, which the
CPU path runs and the kernel is held against.

Without ``pos``, slot j of lane b is visible when ``j < cache_len[b]`` (and
``j > cache_len[b] - 1 - window`` with a window): ``ref.decode_mha_reference``.
With ``pos`` ((B, n) int32, -1 = empty) slot j is visible when
``0 <= pos[b, j] < cache_len[b]`` (and ``pos > cache_len - 1 - window``):
the ring decode site's mask, oracle ``ref.decode_mha_masked``.  The kernel
skips slots at or past ``cache_len``, which is exact for a ring whose slot j
only ever holds positions congruent to j modulo n (``pos >= j``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _counted() -> None:
    global launches
    with _count_lock:
        launches += 1


def auto_splits(b: int, hkv: int, n: int, device) -> int:
    """Slot ranges per (lane, KV head): enough blocks for about two waves
    on the card's SMs, at least 256 slots per range, at most 32."""
    sms = build.sm_count(torch.device(device).index or 0)
    want = -(-2 * sms // (b * hkv))
    return max(1, min(want, -(-n // 256), 32))


def _check(q, k_cache, v_cache, cache_len, pos):
    b, one, hq, d = q.shape
    if one != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    kb, n, hkv, kd = k_cache.shape
    if kb != b or kd != d or hq % hkv or (hq // hkv) not in (1, 2, 4, 8) \
            or d not in (64, 128):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32:
        raise ValueError("decode_attention: cache_len must be (B,) int32")
    if pos is not None and (pos.shape != (b, n) or pos.dtype != torch.int32):
        raise ValueError("decode_attention: pos must be (B, n) int32")
    for t in (q, k_cache, v_cache, cache_len) + (() if pos is None else (pos,)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention: tensors must be contiguous "
                             "and on one device")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q and the caches must be "
                             "16-byte aligned (rows are vector loads)")


def decode_attention(q, k_cache, v_cache, *, cache_len, pos=None, window=0,
                     scale, softcap=0.0, splits=None):
    """Launch the Hopper kernel.  q: (B, 1, Hq, D); caches (B, n, Hkv, D);
    ``cache_len`` (B,) int32; ``pos`` (B, n) int32 or None.  Returns
    (B, 1, Hq, D) in q's dtype.  CUDA tensors only.  ``splits`` is the
    number of slot ranges per (lane, KV head), ``auto_splits`` by
    default; 1 runs a single pass with no combine."""
    if q.device.type != "cuda":
        raise RuntimeError("decode_attention kernel needs CUDA tensors; "
                           "use decode_attention_plain on the CPU")
    _check(q, k_cache, v_cache, cache_len, pos)
    b, _, hq, d = q.shape
    n, hkv = k_cache.shape[1], k_cache.shape[2]
    if splits is None:
        splits = auto_splits(b, hkv, n, q.device)
    out = torch.empty_like(q)
    # per (lane, query head, split): (max, sum) and a D-wide accumulator
    work = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = build.library("decode_attention", _ARGTYPES).decode_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), None if pos is None else pos.data_ptr(),
                 out.data_ptr(), None if work is None else work.data_ptr(),
                 b, n, hq, hkv, d, _DTYPES[q.dtype], int(splits), int(window),
                 float(scale), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    _counted()
    return out


def decode_attention_plain(q, k_cache, v_cache, *, cache_len, pos=None,
                           window=0, scale, softcap=0.0):
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    if pos is None:
        return ref.decode_mha_reference(q, k_cache, v_cache,
                                        cache_len=cache_len, window=window,
                                        scale=scale, softcap=softcap)
    cl = cache_len.reshape(-1, 1)
    valid = (pos >= 0) & (pos < cl)
    if window > 0:
        valid &= pos > cl - 1 - window
    return ref.decode_mha_masked(q, k_cache, v_cache, valid_mask=valid,
                                 scale=scale, softcap=softcap)

"""Decode attention: one query token per lane over its KV cache.

Kernel: ``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``), replacing
the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``
(``_decode_kernel``).  ``decode_attention`` launches it on CUDA tensors;
``decode_attention_plain`` is the same function in plain PyTorch, which the
CPU path runs and the kernel is held against.

It is bound by the bytes of K and V it must read.  In bf16 one block per
(KV head, lane, slot range) holds every query head of the GQA group, so
K and V are read once at every ratio (1 to 16); tiles of 64 slots stream through two
or three shared-memory stages by ``cp.async`` with the ``pos`` entries
beside them (no K/V copy waits on a ``pos`` load); scores and P·V run on
the tensor cores (``mma.sync``, f32 accumulation, P rounded to bf16 where
the oracle rounds it).  Each lane's slots are split over several blocks
(flash-decoding), whose partial softmax states a second kernel merges.
f32 inputs take a CUDA-core body of the same function, selected by dtype
(the identity checks run f32); both routes launch or raise.

Without ``pos``, slot j of lane b is visible when ``j < cache_len[b]`` (and
``j > cache_len[b] - 1 - window`` with a window): ``ref.decode_mha_reference``.
With ``pos`` ((B, n) int32, -1 = empty) slot j is visible when
``0 <= pos[b, j] < cache_len[b]`` (and ``pos > cache_len - 1 - window``):
the ring decode site's mask, oracle ``ref.decode_mha_masked``.  The kernel
skips slots at or past ``cache_len``, which is exact for a ring whose slot j
only ever holds positions congruent to j modulo n (``pos >= j``).

A serving mesh splits a ring's slots over shards: ``decode_attention_partials``
launches the kernel without its merge and returns every split's partial
softmax state, and ``attention_combine`` merges the states of all shards
(``rt::combine_splits``, a second entry point of the same source).  Their
plain versions are ``ref.local_attend`` by split and ``ref.combine_partials``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

# kernel launches (plain-version calls excluded): the ordinary launch, the
# partials launch and the combine, each counted apart
launches = 0
partial_launches = 0
combine_launches = 0
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _counted(counter: str = "launches") -> None:
    with _count_lock:
        globals()[counter] += 1


def auto_splits(b: int, hkv: int, n: int, device) -> int:
    """Slot ranges per (lane, KV head), each one block that holds the
    whole GQA group: enough blocks for about two waves on the card's SMs,
    at least 128 slots per range, at most 32."""
    sms = build.sm_count(torch.device(device).index or 0)
    want = -(-2 * sms // (b * hkv))
    return max(1, min(want, -(-n // 128), 32))


def _check(q, k_cache, v_cache, cache_len, pos):
    b, one, hq, d = q.shape
    if one != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    kb, n, hkv, kd = k_cache.shape
    if kb != b or kd != d or hq % hkv or not 1 <= hq // hkv <= 16 \
            or d not in (64, 128, 256):
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


def partials_buffers(rows: int, splits: int, d: int, device):
    """Empty (ml, part) for ``rows`` output rows of ``splits`` partial
    states: (rows, splits, 2) and (rows, splits, d) float32."""
    return (torch.empty((rows, splits, 2), dtype=torch.float32, device=device),
            torch.empty((rows, splits, d), dtype=torch.float32, device=device))


def decode_attention_partials(q, k_cache, v_cache, *, cache_len, pos=None,
                              window=0, scale, softcap=0.0, splits=None):
    """Launch the kernel without its merge: every split's partial softmax
    state, at any ``splits`` (``auto_splits`` by default; 1 too).  Returns
    (ml, part): (B·Hq, splits, 2) f32 (max logit in natural-log units, sum)
    and (B·Hq, splits, D) f32 (the max-relative accumulator); a split with
    nothing visible holds (-1e30, 0, 0).  ``attention_combine`` merges
    them, with those of other launches (a serving mesh's shards).  Slot j
    is cut from split ranges as in ``decode_attention``: in *this* cache's
    index, so a shard that holds slots [start, start + n) of a ring passes
    ``pos`` (positions in slot j are then at least j).  CUDA tensors
    only."""
    if q.device.type != "cuda":
        raise RuntimeError("decode_attention kernel needs CUDA tensors; "
                           "use decode_attention_partials_plain on the CPU")
    _check(q, k_cache, v_cache, cache_len, pos)
    b, _, hq, d = q.shape
    n, hkv = k_cache.shape[1], k_cache.shape[2]
    if splits is None:
        splits = auto_splits(b, hkv, n, q.device)
    ml, part = partials_buffers(b * hq, splits, d, q.device)
    fn = build.launcher("decode_attention", "decode_attention_partials_launch",
                        _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), None if pos is None else pos.data_ptr(),
                 ml.data_ptr(), part.data_ptr(), b, n, hq, hkv, d,
                 _DTYPES[q.dtype], int(splits), int(window), float(scale),
                 float(softcap), build.current_stream(q.device))
    if err:
        raise RuntimeError(f"decode_attention partials launch failed: CUDA "
                           f"error {err}")
    _counted("partial_launches")
    return ml, part


def attention_combine(ml, part, dtype):
    """Launch ``rt::combine_splits`` over partial states: ``ml`` (R, S, 2)
    and ``part`` (R, S, D) float32, from one partials launch or several
    concatenated along S.  Returns (R, D) in ``dtype`` (float32 or
    bfloat16); a row whose states are all empty comes out as zeros.  CUDA
    tensors only."""
    if ml.device.type != "cuda":
        raise RuntimeError("attention_combine needs CUDA tensors; use "
                           "attention_combine_plain on the CPU")
    rows, splits, d = part.shape
    if ml.shape != (rows, splits, 2) or ml.dtype != torch.float32 \
            or part.dtype != torch.float32 or d not in (64, 128, 256) \
            or dtype not in _DTYPES or ml.device != part.device \
            or not (ml.is_contiguous() and part.is_contiguous()):
        raise ValueError(f"attention_combine: ml {tuple(ml.shape)} "
                         f"{ml.dtype}, part {tuple(part.shape)} {part.dtype}, "
                         f"out {dtype}")
    out = torch.empty((rows, d), dtype=dtype, device=ml.device)
    fn = build.launcher("decode_attention", "attention_combine_launch",
                        _COMBINE_ARGTYPES)
    with torch.cuda.device(ml.device):
        err = fn(ml.data_ptr(), part.data_ptr(), out.data_ptr(), rows, splits,
                 d, _DTYPES[dtype], build.current_stream(ml.device))
    if err:
        raise RuntimeError(f"attention_combine launch failed: CUDA error "
                           f"{err}")
    _counted("combine_launches")
    return out


def split_ranges(cache_len, n: int, has_pos: bool, window: int, splits: int):
    """Slot range [lo, hi) of each split of each lane, (splits, B) each, as
    the kernel's ``split_range`` cuts them: [0, min(len, n)) (from
    ``len - window`` without ``pos``) in ``splits`` equal parts."""
    cl = cache_len.long()
    hi_all = cl.clamp(max=n)
    lo_all = ((cl - window).clamp(min=0) if not has_pos and window > 0
              else torch.zeros_like(cl))
    per = ((hi_all - lo_all).clamp(min=0) + splits - 1) // splits
    lo = lo_all + torch.arange(splits, device=cl.device)[:, None] * per
    return lo, torch.minimum(hi_all, lo + per)


def stack_partials(states):
    """[(m, l, acc)] of ``ref.local_attend``, one a split, as (ml, part)."""
    ml = torch.stack([torch.stack([m, l], dim=-1) for m, l, _ in states], 2)
    part = torch.stack([acc for _, _, acc in states], dim=2)
    b, hq = ml.shape[:2]
    return (ml.reshape(b * hq, len(states), 2),
            part.reshape(b * hq, len(states), part.shape[-1]))


def decode_attention_partials_plain(q, k_cache, v_cache, *, cache_len,
                                    pos=None, window=0, scale, softcap=0.0,
                                    splits=1):
    """``decode_attention_partials`` in plain PyTorch: the split ranges of
    ``split_ranges``, each split's state by ``ref.local_attend``."""
    n = k_cache.shape[1]
    j = torch.arange(n, device=q.device)
    cl = cache_len.reshape(-1, 1)
    if pos is None:
        valid = j < cl
        if window > 0:
            valid = valid & (j > cl - 1 - window)
    else:
        valid = (pos >= 0) & (pos < cl)
        if window > 0:
            valid &= pos > cl - 1 - window
    lo, hi = split_ranges(cache_len, n, pos is not None, window, splits)
    return stack_partials([
        ref.local_attend(q, k_cache, v_cache,
                         valid & (j >= lo[s, :, None]) & (j < hi[s, :, None]),
                         scale, softcap)
        for s in range(splits)])


def attention_combine_plain(ml, part, dtype):
    """``attention_combine`` in plain PyTorch (``ref.combine_partials``)."""
    return ref.combine_partials(ml, part, dtype)


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

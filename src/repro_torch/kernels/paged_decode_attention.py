"""Paged decode attention: one query token per lane over a block-table page
pool.

Kernel: ``csrc/paged_decode_attention.cu`` (CUDA C++ for ``sm_90a``),
replacing the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention``
(``_paged_decode_kernel``).  It is bound by the bytes of the live pages'
K and V.  In bf16 one block per (KV head, lane, page range) holds every
query head of the GQA group, so each K/V row is read once at every ratio (1 to 16);
the range's slice of the lane's table sits in shared memory, and tiles of
64 slots, addressed row by row through it (a tile may span pages), stream
through two or three shared-memory stages by ``cp.async`` with each slot's
``pos`` entry beside them; an absent page (-1) is never read.  Scores and
P·V run on the tensor cores (``mma.sync``, f32 sums, P rounded to bf16
where the oracle rounds it).  Each lane's pages are split over several
blocks (flash-decoding), whose partial softmax states a second kernel
merges.  f32 inputs take a CUDA-core body of the same function, selected by
dtype (the identity checks run f32); both routes launch or raise.
``paged_decode_attention`` launches it on CUDA tensors;
``paged_decode_attention_plain`` is the oracle
``ref.paged_decode_mha_reference``, which the CPU path runs and the kernel
is held against.

Lane b's position r lives in pool row ``tables[b, r // page]``, slot
``r % page``; it is visible when that entry is >= 0, ``pos`` there equals
r, ``r < cache_len[b]`` and r is inside the window.
``paged_decode_attention_partials`` is the same kernel without its merge,
for a serving mesh's shard of the pool; ``decode_attention.attention_combine``
joins the shards.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (partials_buffers,
                                                  stack_partials)

# kernel launches (plain-version calls excluded): the ordinary launch and
# the partials launch, counted apart
launches = 0
partial_launches = 0
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# table entries (pages) one block of the bf16 kernel holds in shared memory
MAX_TABLE_SLICE = 8192


def _counted(counter: str = "launches") -> None:
    with _count_lock:
        globals()[counter] += 1


def auto_splits(b: int, hkv: int, maxp: int, page: int, device) -> int:
    """Page ranges per (lane, KV head), each one block that holds the
    whole GQA group: enough blocks for about two waves on the card's SMs,
    at least 256 positions' worth of pages per range, at most 32, and
    enough that a range's table slice fits ``MAX_TABLE_SLICE``."""
    sms = build.sm_count(torch.device(device).index or 0)
    want = -(-2 * sms // (b * hkv))
    min_pages = -(-256 // page)
    return max(1, min(want, -(-maxp // min_pages), 32),
               -(-maxp // MAX_TABLE_SLICE))


def _check(q, k_pages, v_pages, pos_pages, tables, cache_len):
    b, one, hq, d = q.shape
    if one != 1 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    npool, page, hkv, kd = k_pages.shape
    if kd != d or hq % hkv or not 1 <= hq // hkv <= 16 \
            or d not in (64, 128, 256):
        raise ValueError(f"paged_decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, pool {tuple(k_pages.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: dtypes {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if pos_pages.shape != (npool, page) or pos_pages.dtype != torch.int32:
        raise ValueError("paged_decode_attention: pos must be (P, page) int32")
    if tables.dim() != 2 or tables.shape[0] != b \
            or tables.dtype != torch.int32:
        raise ValueError("paged_decode_attention: tables must be (B, maxp) "
                         "int32")
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32:
        raise ValueError("paged_decode_attention: cache_len must be (B,) "
                         "int32")
    for t in (q, k_pages, v_pages, pos_pages, tables, cache_len):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_decode_attention: tensors must be "
                             "contiguous and on one device")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("paged_decode_attention: q and the pools must "
                             "be 16-byte aligned (rows are vector loads)")


def paged_decode_attention(q, k_pages, v_pages, pos_pages, tables, *,
                           cache_len, window=0, scale, softcap=0.0,
                           splits=None):
    """Launch the Hopper kernel.  q: (B, 1, Hq, D); pools (P, page, Hkv, D);
    ``pos_pages`` (P, page), ``tables`` (B, maxp) and ``cache_len`` (B,)
    int32.  Returns (B, 1, Hq, D) in q's dtype.  CUDA tensors only.
    ``splits`` is the number of page ranges per (lane, KV head),
    ``auto_splits`` by default; 1 runs a single pass with no combine."""
    if q.device.type != "cuda":
        raise RuntimeError("paged_decode_attention kernel needs CUDA "
                           "tensors; use paged_decode_attention_plain on "
                           "the CPU")
    _check(q, k_pages, v_pages, pos_pages, tables, cache_len)
    b, _, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = tables.shape[1]
    if splits is None:
        splits = auto_splits(b, hkv, maxp, page, q.device)
    if q.dtype == torch.bfloat16 and -(-maxp // splits) > MAX_TABLE_SLICE:
        raise ValueError(f"paged_decode_attention: {maxp} table entries in "
                         f"{splits} splits exceed {MAX_TABLE_SLICE} a block")
    out = torch.empty_like(q)
    # per (lane, query head, split): (max, sum) and a D-wide accumulator
    work = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = build.library("paged_decode_attention",
                       _ARGTYPES).paged_decode_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 pos_pages.data_ptr(), tables.data_ptr(), cache_len.data_ptr(),
                 out.data_ptr(), None if work is None else work.data_ptr(),
                 b, maxp, page, hq, hkv, d, _DTYPES[q.dtype], int(splits),
                 int(window), float(scale), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"paged_decode_attention launch failed: CUDA error {err}")
    _counted()
    return out


def paged_decode_attention_partials(q, k_pages, v_pages, pos_pages, tables,
                                    *, cache_len, window=0, scale,
                                    softcap=0.0, splits=None):
    """Launch the kernel without its merge: every split's partial softmax
    state, at any ``splits`` (``auto_splits`` by default; 1 too), as
    ``decode_attention.decode_attention_partials`` returns them.  A serving
    mesh's shard passes the pool rows it holds and a table of local row
    ids, -1 for pages held elsewhere.  A split with nothing visible holds
    (-1e30, 0, 0) (an empty lane gets no mean of V here: that is the whole
    lane's answer).  CUDA tensors only."""
    if q.device.type != "cuda":
        raise RuntimeError("paged_decode_attention kernel needs CUDA "
                           "tensors; use paged_decode_attention_partials_"
                           "plain on the CPU")
    _check(q, k_pages, v_pages, pos_pages, tables, cache_len)
    b, _, hq, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = tables.shape[1]
    if splits is None:
        splits = auto_splits(b, hkv, maxp, page, q.device)
    if q.dtype == torch.bfloat16 and -(-maxp // splits) > MAX_TABLE_SLICE:
        raise ValueError(f"paged_decode_attention: {maxp} table entries in "
                         f"{splits} splits exceed {MAX_TABLE_SLICE} a block")
    ml, part = partials_buffers(b * hq, splits, d, q.device)
    fn = build.launcher("paged_decode_attention",
                        "paged_decode_attention_partials_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 pos_pages.data_ptr(), tables.data_ptr(), cache_len.data_ptr(),
                 ml.data_ptr(), part.data_ptr(), b, maxp, page, hq, hkv, d,
                 _DTYPES[q.dtype], int(splits), int(window), float(scale),
                 float(softcap), build.current_stream(q.device))
    if err:
        raise RuntimeError(f"paged_decode_attention partials launch failed: "
                           f"CUDA error {err}")
    _counted("partial_launches")
    return ml, part


def split_ranges(cache_len, maxp: int, page: int, window: int, splits: int):
    """Position range [lo, hi) of each split of each lane, (splits, B)
    each, as the kernel cuts them: the pages of [lo_all, hi_all) in
    ``splits`` equal page-aligned parts."""
    cl = cache_len.long()
    hi_all = cl.clamp(min=0, max=maxp * page)
    lo_all = torch.minimum((cl - window).clamp(min=0) if window > 0
                           else torch.zeros_like(cl), hi_all)
    pg_lo, pg_hi = lo_all // page, (hi_all + page - 1) // page
    per = (pg_hi - pg_lo + splits - 1) // splits
    pa = pg_lo + torch.arange(splits, device=cl.device)[:, None] * per
    pb = torch.minimum(pg_hi, pa + per)
    return (torch.maximum(lo_all, pa * page),
            torch.minimum(hi_all, pb * page))


def paged_decode_attention_partials_plain(q, k_pages, v_pages, pos_pages,
                                          tables, *, cache_len, window=0,
                                          scale, softcap=0.0, splits=1):
    """``paged_decode_attention_partials`` in plain PyTorch: the lanes'
    pages gathered as the oracle gathers them (``ref.paged_gather``), the
    split ranges of ``split_ranges``, each split's state by
    ``ref.local_attend``."""
    k, v, valid = ref.paged_gather(k_pages, v_pages, pos_pages, tables,
                                   cache_len, window)
    r = torch.arange(k.shape[1], device=q.device)
    lo, hi = split_ranges(cache_len, tables.shape[1], k_pages.shape[1],
                          window, splits)
    return stack_partials([
        ref.local_attend(q, k, v,
                         valid & (r >= lo[s, :, None]) & (r < hi[s, :, None]),
                         scale, softcap)
        for s in range(splits)])


def paged_decode_attention_plain(q, k_pages, v_pages, pos_pages, tables, *,
                                 cache_len, window=0, scale, softcap=0.0):
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    return ref.paged_decode_mha_reference(
        q, k_pages, v_pages, pos_pages, tables, cache_len=cache_len,
        window=window, scale=scale, softcap=softcap)

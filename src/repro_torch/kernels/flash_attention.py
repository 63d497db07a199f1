"""Flash attention forward with position masks (prefill and chunked prefill).

Kernel: ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``), replacing
the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``).  The source's header says what bounds it on the card
and what its design does about that (a chunk's keys are split over
several blocks, whose partial softmax states a second kernel merges).
``flash_attention`` launches it on CUDA tensors; ``flash_attention_plain``
is the same function in plain PyTorch, which the CPU path runs and the
kernel is held against.

Key j of row b is visible to query i when ``k_pos[b, j] >= 0``, and
``k_pos <= q_pos`` when causal, and ``k_pos > q_pos - window`` with a
window.  Whole-prompt prefill passes ``q_pos = k_pos = arange(S)``
(``ref.mha_reference``); chunked prefill passes the ring's ``pos`` plane
followed by the chunk's positions (``ref.mha_cache_masked``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BQ = 16                     # query rows per block (csrc/flash_attention.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def auto_splits(b: int, s: int, hq: int, t: int, device) -> int:
    """Key ranges per query tile: enough blocks for about two waves on the
    card's SMs (a chunk has few query tiles; a whole prompt has plenty),
    at least 256 keys per range, at most 32."""
    sms = build.sm_count(torch.device(device).index or 0)
    want = -(-2 * sms // (-(-s // _BQ) * hq * b))
    return max(1, min(want, -(-t // 256), 32, 65535 // b))


def _check(q, k, v):
    b, s, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[2]
    if hq % hkv or d not in (64, 128):
        raise ValueError(f"flash_attention: unsupported heads/head_dim "
                         f"{hq}/{hkv}/{d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: tensors must be 16-byte "
                             "aligned (the kernel loads 16 bytes at a time)")


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale,
                    softcap=0.0, splits=None):
    """Launch the Hopper kernel.  q: (B, S, Hq, D); k, v: (B, T, Hkv, D);
    ``q_pos`` (S,) or (B, S), ``k_pos`` (T,) or (B, T) integer positions
    (-1 = empty key slot).  Returns (B, S, Hq, D) in q's dtype.
    ``splits`` is the number of key ranges per query tile, ``auto_splits``
    by default; 1 runs a single pass with no combine."""
    if q.device.type != "cuda":
        raise RuntimeError("flash_attention kernel needs CUDA tensors; "
                           "use flash_attention_plain on the CPU")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qp = _positions(q_pos, b, s, q.device)
    kp = _positions(k_pos, b, t, q.device)
    if splits is None:
        splits = auto_splits(b, s, hq, t, q.device)
    out = torch.empty_like(q)
    # per (batch row, query row, head, split): (max, sum) and a D-wide
    # accumulator
    work = (torch.empty(b * s * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = build.library("flash_attention", _ARGTYPES).flash_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), b, s, t, hq, hkv,
                 d, _DTYPES[q.dtype], int(splits), int(bool(causal)),
                 int(window), float(scale), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _counted()
    return out


def flash_attention_plain(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                          scale, softcap=0.0):
    """The same function in plain PyTorch (the CPU path and the oracle):
    builds the (B, S, T) mask from the positions and runs
    ``ref.mha_cache_masked`` (f32 softmax)."""
    b, s = q.shape[0], q.shape[1]
    t = k.shape[1]
    qp = _positions(q_pos, b, s, q.device)[:, :, None]
    kp = _positions(k_pos, b, t, q.device)[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return ref.mha_cache_masked(q, k, v, mask=m, scale=scale, softcap=softcap)

"""Flash attention with position masks (prefill, chunked prefill and
training), forward and backward.

Kernel: ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``), replacing
the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``).  ``flash_attention`` launches it on CUDA tensors;
``flash_attention_plain`` is the same function in plain PyTorch, which the
CPU path runs and the kernel is held against.  With ``return_lse`` both
also give each row's log-sum-exp (B, Hq, S) f32, which the backward reads;
the serving path never asks for it, and the kernel then writes none.

Backward: ``csrc/flash_attention_bwd.cu``, FlashAttention-2's recompute
from the log-sum-exp (dQ, dK, dV; deterministic, no atomics), launched by
``flash_attention_bwd``; ``flash_attention_bwd_plain`` is the same
algorithm in plain PyTorch.  In bf16 its products run on the tensor cores
(``mma.sync``), P and dS split into bf16 hi + lo as the forward splits P;
f32 inputs take a CUDA-core body, selected by dtype.  The TPU kernel has
no backward (the JAX
package differentiates its jnp path); the port's forward is the kernel,
so its gradient is one too.  ``FlashAttentionFn`` is the
``torch.autograd.Function`` that ``ops.flash_attention`` routes a CUDA
call through when an input needs a gradient: its forward launches the
forward kernel with the log-sum-exp, its backward the backward kernel.
The backward takes D 64, 128 or 256 (at D 256 a dK/dV block owns half of
the columns and one group of the GQA group's heads, ``bwd_kv_groups``,
and a second launch adds the groups' f32 partials in order) and a softcap
(the lse is the capped logits', and dS takes the cap's derivative ``1 -
t^2``), but no ring; a call under grad outside that raises
``NotImplementedError`` before anything runs.

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
bwd_launches = 0             # backward kernel launches
_count_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BWD_HEAD_DIMS = (64, 128, 256)
BWD_KEY_TILE = 64            # keys of a dK/dV block's tile
_BWD_TODO = "ROADMAP.md §3 item 24 (the backward kernel: the ring)"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Launch geometry, as csrc/flash_attention.cu has it: a bf16 block owns
# _BM packed rows; a split walks at most _MAX_TILES key tiles (its live-tile
# mask), of 32 keys at the smallest.  The kernel's shared-memory layout
# stays in the .cu file, checked there at compile time.
_BM = 64
_MAX_TILES = 4096


def _counted(bwd: bool = False) -> None:
    global launches, bwd_launches
    with _count_lock:
        if bwd:
            bwd_launches += 1
        else:
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
                    cache_pos=None, return_lse=False):
    """Launch the Hopper kernel.  q: (B, S, Hq, D); k, v: (B, C, Hkv, D);
    ``q_pos`` (S,) or (B, S), ``k_pos`` (C,) or (B, C) integer positions
    (-1 = empty key slot).  With a ring, ``k_cache``/``v_cache`` (B, n,
    Hkv, D) and ``cache_pos`` (B, n) int32 are keys [0, n), ahead of the
    chunk's.  Returns (B, S, Hq, D) in q's dtype, and with ``return_lse``
    also the rows' log-sum-exp (B, Hq, S) f32 (-1e30 for a row with no
    visible key).  ``splits`` is the number of key ranges per row tile,
    ``auto_splits`` by default (1 with ``return_lse``); 1 runs a single
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
    if return_lse:
        if splits not in (None, 1):
            raise ValueError("flash_attention: the log-sum-exp needs one "
                             "split")
        splits = 1
    if splits is None:
        splits = auto_splits(b, s, hq, hkv, n + c, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    # per (batch row, query row, head, split): (max, sum) and a D-wide
    # accumulator
    work = (torch.empty(b * s * hq * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = build.library("flash_attention", _ARGTYPES).flash_attention_launch
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_cache),
                 ptr(v_cache), qp.data_ptr(), kp.data_ptr(), ptr(cache_pos),
                 out.data_ptr(), ptr(work), ptr(lse), b, s, c, n, hq, hkv, d,
                 _DTYPES[q.dtype], int(splits), int(bool(causal)),
                 int(window), float(scale), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _counted()
    return (out, lse) if return_lse else out


def _mask(q_pos, k_pos, b: int, s: int, t: int, causal, window, device):
    """(B, S, T) visibility of key j to query i from the positions."""
    qp = _positions(q_pos, b, s, device)[:, :, None]
    kp = _positions(k_pos, b, t, device)[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m


def flash_attention_plain(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                          scale, softcap=0.0, k_cache=None, v_cache=None,
                          cache_pos=None, return_lse=False):
    """The same function in plain PyTorch (the CPU path and the oracle):
    puts the ring's keys ahead of the chunk's, builds the (B, S, T) mask
    from the positions and runs ``ref.mha_cache_masked`` (f32 softmax).
    With ``return_lse`` also the rows' log-sum-exp (B, Hq, S) f32 over
    their visible logits."""
    b, s = q.shape[0], q.shape[1]
    kp = _positions(k_pos, b, k.shape[1], q.device)
    if k_cache is not None:
        k = torch.cat([k_cache, k], dim=1)
        v = torch.cat([v_cache, v], dim=1)
        kp = torch.cat([_positions(cache_pos, b, k_cache.shape[1], q.device),
                        kp], dim=1)
    m = _mask(q_pos, kp, b, s, k.shape[1], causal, window, q.device)
    out = ref.mha_cache_masked(q, k, v, mask=m, scale=scale, softcap=softcap)
    if not return_lse:
        return out
    logits = _logits(q, k, scale, softcap)
    lse = torch.logsumexp(logits.masked_fill(~m[:, None], ref.NEG_INF), -1)
    return out, lse


def _logits(q, k, scale, softcap=0.0):
    """(B, Hq, S, T) f32 logits of q (B, S, Hq, D) over k (B, T, Hkv, D)."""
    k = ref._gqa_expand(k, q.shape[2])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    return softcap * torch.tanh(s / softcap) if softcap else s


# ------------------------------------------------------------- backward
def _bwd_supported(q, k_cache) -> None:
    """Raise ``NotImplementedError`` for what the backward kernel does not
    take, before a forward under grad runs."""
    if k_cache is not None or q.shape[-1] not in _BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention backward: head_dim {q.shape[-1]}, ring "
            f"{k_cache is not None}; the kernel takes D {_BWD_HEAD_DIMS} "
            f"and no ring ({_BWD_TODO})")


def bwd_kv_groups(b: int, t: int, hq: int, hkv: int, sms: int) -> int:
    """Head groups of the bf16 dK/dV grid at D 256, whose blocks are (pair
    of key tiles, head group, batch row, KV head, column half): the fewest
    groups that give each of ``sms`` SMs a block, rounded up to a divisor
    of the GQA group's ``hq / hkv`` heads so that the groups are equal."""
    rep = hq // hkv
    units = (-(-t // BWD_KEY_TILE) + 1) // 2 * b * hkv * 2
    want = min(rep, -(-sms // units))
    return next(g for g in range(want, rep + 1) if rep % g == 0)


def flash_attention_bwd(q, k, v, out, lse, dout, *, q_pos, k_pos,
                        causal=True, window=0, scale, softcap=0.0):
    """Launch the backward kernel: (dq, dk, dv) in the inputs' shapes and
    dtype.  ``out`` and ``lse`` are the forward's (``return_lse``), ``dout``
    the gradient of ``out``.  CUDA tensors, D 64, 128 or 256; with
    ``softcap`` the forward's lse is the capped logits'."""
    if q.device.type != "cuda":
        raise RuntimeError("flash_attention_bwd kernel needs CUDA tensors; "
                           "use flash_attention_bwd_plain on the CPU")
    _bwd_supported(q, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, dout = out.contiguous(), dout.contiguous()
    _check(q, k, v, None, None, None)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    for x in (out, dout):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or x.data_ptr() % 16:
            raise ValueError("flash_attention_bwd: out and dout must be "
                             "q's shape, dtype and device, 16-byte aligned")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} for ({b}, {hq}, {s}) float32")
    qp = _positions(q_pos, b, s, q.device)
    kp = _positions(k_pos, b, t, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    # bf16 at D 256: the head groups' f32 partials of dK and dV
    groups, part = 1, None
    if q.dtype == torch.bfloat16 and d == 256:
        sms = build.sm_count(q.device.index or 0)
        groups = bwd_kv_groups(b, t, hq, hkv, sms)
        part = torch.empty(2 * groups * k.numel(), dtype=torch.float32,
                           device=q.device)
    fn = build.library("flash_attention_bwd",
                       _BWD_ARGTYPES).flash_attention_bwd_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), delta.data_ptr(),
                 None if part is None else part.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, s, t, hq, hkv, d,
                 _DTYPES[q.dtype], int(bool(causal)), int(window), groups,
                 float(scale), float(softcap), build.current_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    _counted(bwd=True)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, q_pos, k_pos,
                              causal=True, window=0, scale, softcap=0.0):
    """The backward kernel's algorithm in plain PyTorch, in f32: ``delta =
    rowsum(dout * out)``, ``P = exp(S * scale - lse)`` on the visible
    pairs, ``dV = P^T dout``, ``dS = P * (dout V^T - delta)``, ``dK = dS^T
    Q * scale``, ``dQ = dS K * scale``, the GQA groups summed into their KV
    head.  With ``softcap`` c the logits are ``c * t``, ``t = tanh(S *
    scale / c)``, so ``P = exp(c * t - lse)`` (``lse`` the capped
    logits') and dS takes ``1 - t^2``.  A row with no visible key gets no
    gradient (the kernel's forward writes zeros there).  Returns (dq, dk,
    dv) in the inputs' dtypes."""
    b, s, hq, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    m = _mask(q_pos, k_pos, b, s, t, causal, window, q.device)[:, None]
    kx, vx = ref._gqa_expand(k, hq).float(), ref._gqa_expand(v, hq).float()
    qf, do = q.float(), dout.float()
    logits = _logits(q, k, scale, softcap)
    p = torch.where(m, torch.exp(logits - lse[..., None]), 0.0)
    delta = (do * out.float()).sum(-1).transpose(1, 2)        # (B, Hq, S)
    dv = torch.einsum("bhst,bshd->bthd", p, do)
    dp = torch.einsum("bshd,bthd->bhst", do, vx)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - torch.square(logits / softcap))
    dq = torch.einsum("bhst,bthd->bshd", ds, kx) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    rep = hq // hkv
    dk = dk.reshape(b, t, hkv, rep, -1).sum(3)
    dv = dv.reshape(b, t, hkv, rep, -1).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd on the card: the forward kernel with
    its log-sum-exp, and the backward kernel.  Inputs (q, k, v, q_pos,
    k_pos, causal, window, scale, softcap); no ring, D 64, 128 or 256
    (``ops.flash_attention`` checks before it applies this)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale, softcap):
        kw = dict(causal=causal, window=window, scale=scale, softcap=softcap)
        out, lse = flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                   splits=1, return_lse=True, **kw)
        qp = torch.as_tensor(q_pos, device=q.device)
        kp = torch.as_tensor(k_pos, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse, qp, kp)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qp, kp = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, q_pos=qp,
                                         k_pos=kp, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None

"""Kernel entry points the model calls, dispatched by tensor device only.

A CPU tensor takes the plain PyTorch version, which autograd
differentiates; a CUDA tensor takes the Hopper kernel, which launches or
raises.  There is no environment switch and no fallback from a failed
kernel to the plain version.

Gradients on the card: a kernel's output is written through ctypes and
carries no autograd graph, so when grad mode is on and a CUDA input
requires a gradient, ``flash_attention``, the four norm entry points,
``ssd`` and ``rglru`` go through their ``torch.autograd.Function``s
(forward kernel, then backward kernel: ``FlashAttentionFn``,
``RMSNormFn``, ``RMSNormPairFn``, ``AddRMSNormFn``, ``GatedRMSNormFn``,
``SSDFn``, ``RGLRUFn``); otherwise, as on every serving call, they launch
directly.  The decode kernels have no backward and raise
``NotImplementedError`` in that case, as flash does with a ring: they
never return an output cut from its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rmsnorm as _norm
from repro_torch.kernels import ssd_scan as _ssd


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for device {t.device}")


def _grad(*ts) -> bool:
    """Whether autograd would record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_backward(name: str, *ts) -> None:
    """Raise where a kernel without a backward would be recorded."""
    if _grad(*ts):
        raise NotImplementedError(
            f"{name} has no backward kernel (decode runs no training "
            "step): its CUDA output would carry no gradient")


def rmsnorm(x, scale, eps: float = 1e-6):
    """(..., D) RMSNorm with (1 + scale) gain, f32 statistics."""
    if not _route(x):
        return _norm.rmsnorm_plain(x, scale, eps)
    if _grad(x, scale):
        return _norm.RMSNormFn.apply(x, scale, eps)
    return _norm.rmsnorm(x, scale, eps)


def rmsnorm_pair(q, k, q_scale, k_scale, eps: float = 1e-6):
    """(rmsnorm(q, q_scale), rmsnorm(k, k_scale)): the qk-norm, one launch."""
    if not _route(q):
        return _norm.rmsnorm_pair_plain(q, k, q_scale, k_scale, eps)
    if _grad(q, k, q_scale, k_scale):
        return _norm.RMSNormPairFn.apply(q, k, q_scale, k_scale, eps)
    return _norm.rmsnorm_pair(q, k, q_scale, k_scale, eps)


def add_rmsnorm(x, y, scale, eps: float = 1e-6):
    """(x + y, rmsnorm(x + y, scale)): a residual add and the next norm."""
    if not _route(x):
        return _norm.add_rmsnorm_plain(x, y, scale, eps)
    if _grad(x, y, scale):
        return _norm.AddRMSNormFn.apply(x, y, scale, eps)
    return _norm.add_rmsnorm(x, y, scale, eps)


def gated_rmsnorm(y, z, scale, eps: float = 1e-6):
    """rmsnorm(y * silu(z), scale): Mamba2's gated output norm."""
    if not _route(y):
        return _norm.gated_rmsnorm_plain(y, z, scale, eps)
    if _grad(y, z, scale):
        return _norm.GatedRMSNormFn.apply(y, z, scale, eps)
    return _norm.gated_rmsnorm(y, z, scale, eps)


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale,
                    softcap=0.0, k_cache=None, v_cache=None, cache_pos=None):
    """(B,S,Hq,D) x (B,C,Hkv,D) -> (B,S,Hq,D) under position masks; with
    a ring (``k_cache``/``v_cache`` (B,n,Hkv,D), ``cache_pos`` (B,n)) its
    slots are keys ahead of the chunk's."""
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
              scale=scale)
    ring = dict(softcap=softcap, k_cache=k_cache, v_cache=v_cache,
                cache_pos=cache_pos)
    if not _route(q):
        return _flash.flash_attention_plain(q, k, v, **kw, **ring)
    if _grad(q, k, v, k_cache, v_cache):
        _flash._bwd_supported(q, k_cache)
        return _flash.FlashAttentionFn.apply(q, k, v, q_pos, k_pos, causal,
                                             window, scale, softcap)
    return _flash.flash_attention(q, k, v, **kw, **ring)


def decode_attention(q, k_cache, v_cache, *, cache_len, pos=None, window=0,
                     scale, softcap=0.0):
    """(B,1,Hq,D) over (B,n,Hkv,D) caches with per-lane lengths."""
    if not _route(q):
        fn = _decode.decode_attention_plain
    else:
        _no_backward("decode_attention", q, k_cache, v_cache)
        fn = _decode.decode_attention
    return fn(q, k_cache, v_cache, cache_len=cache_len, pos=pos,
              window=window, scale=scale, softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, pos_pages, tables, *,
                           cache_len, window=0, scale, softcap=0.0):
    """(B,1,Hq,D) over (P,page,Hkv,D) pools through (B,maxp) block tables
    with per-lane lengths."""
    if not _route(q):
        fn = _paged.paged_decode_attention_plain
    else:
        _no_backward("paged_decode_attention", q, k_pages, v_pages)
        fn = _paged.paged_decode_attention
    return fn(q, k_pages, v_pages, pos_pages, tables, cache_len=cache_len,
              window=window, scale=scale, softcap=softcap)


def decode_attention_partials(q, k_cache, v_cache, *, cache_len, pos=None,
                              window=0, scale, softcap=0.0, splits=None):
    """The decode kernel's partial softmax states (ml (B·Hq, splits, 2),
    part (B·Hq, splits, D), f32) without their merge: one serving-mesh
    shard's share of ``decode_attention``.  The CPU takes one split unless
    ``splits`` asks for more."""
    kw = dict(cache_len=cache_len, pos=pos, window=window, scale=scale,
              softcap=softcap)
    if not _route(q):
        return _decode.decode_attention_partials_plain(
            q, k_cache, v_cache, splits=splits or 1, **kw)
    _no_backward("decode_attention", q, k_cache, v_cache)
    return _decode.decode_attention_partials(q, k_cache, v_cache,
                                             splits=splits, **kw)


def paged_decode_attention_partials(q, k_pages, v_pages, pos_pages, tables,
                                    *, cache_len, window=0, scale,
                                    softcap=0.0, splits=None):
    """The paged decode kernel's partial softmax states without their
    merge, as ``decode_attention_partials`` returns them."""
    kw = dict(cache_len=cache_len, window=window, scale=scale,
              softcap=softcap)
    if not _route(q):
        return _paged.paged_decode_attention_partials_plain(
            q, k_pages, v_pages, pos_pages, tables, splits=splits or 1, **kw)
    _no_backward("paged_decode_attention", q, k_pages, v_pages)
    return _paged.paged_decode_attention_partials(
        q, k_pages, v_pages, pos_pages, tables, splits=splits, **kw)


def attention_combine(ml, part, dtype):
    """(R, D) in ``dtype`` from partial states (R, S, 2) and (R, S, D)
    concatenated from any number of partials calls: their log-sum-exp
    merge."""
    if not _route(ml):
        return _decode.attention_combine_plain(ml, part, dtype)
    return _decode.attention_combine(ml, part, dtype)


def ssd(x, dt, a_log, b_mat, c_mat, d_skip=None, chunk=128):
    """Zero-state chunked SSD scan: (B,S,H,P) in x's dtype."""
    if not _route(x):
        return _ssd.ssd_plain(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)
    if _grad(x, dt, a_log, b_mat, c_mat, d_skip):
        return _ssd.SSDFn.apply(x, dt, a_log, b_mat, c_mat, d_skip, chunk)
    return _ssd.ssd(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)


def rglru(x, log_a, gate_x):
    """Zero-state RG-LRU scan over (B,S,D), in x's dtype."""
    if not _route(x):
        return _rglru.rglru_plain(x, log_a, gate_x)
    if _grad(x, log_a, gate_x):
        return _rglru.RGLRUFn.apply(x, log_a, gate_x)
    return _rglru.rglru(x, log_a, gate_x)


# model functions, not TPU kernels (jnp in the JAX package too): plain
# PyTorch on every device
ssd_decode_step = ref.ssd_decode_step
rglru_decode_step = ref.rglru_decode_step
causal_conv1d = ref.causal_conv1d
causal_conv1d_step = ref.causal_conv1d_step


# kernel name -> (module, its counter)
_COUNTED = {"decode_attention": (_decode, "launches"),
            "flash_attention": (_flash, "launches"),
            "rmsnorm": (_norm, "launches"),
            "paged_decode_attention": (_paged, "launches"),
            "ssd": (_ssd, "launches"), "rglru": (_rglru, "launches"),
            "flash_attention_bwd": (_flash, "bwd_launches"),
            "rmsnorm_bwd": (_norm, "bwd_launches"),
            "ssd_bwd": (_ssd, "bwd_launches"),
            "rglru_bwd": (_rglru, "bwd_launches"),
            "decode_attention_partials": (_decode, "partial_launches"),
            "paged_decode_attention_partials": (_paged, "partial_launches"),
            "attention_combine": (_decode, "combine_launches")}


def kernel_launches() -> dict:
    """Launch counts of the ten kernels, the six forward kernels and the
    four backward ones (flash, the norm forms, ``ssd``, ``rglru``), and of
    the decode kernels' partials and combine entry points, which a serving
    mesh runs (plain-version calls excluded)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTED.items()}


def reset_kernel_launches() -> None:
    for mod, attr in _COUNTED.values():
        with mod._count_lock:
            setattr(mod, attr, 0)

"""Kernel entry points the model calls, dispatched by tensor device only.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
Hopper kernel, which launches or raises.  There is no environment switch
and no fallback from a failed kernel to the plain version.
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


def rmsnorm(x, scale, eps: float = 1e-6):
    """(..., D) RMSNorm with (1 + scale) gain, f32 statistics."""
    fn = _norm.rmsnorm if _route(x) else _norm.rmsnorm_plain
    return fn(x, scale, eps)


def rmsnorm_pair(q, k, q_scale, k_scale, eps: float = 1e-6):
    """(rmsnorm(q, q_scale), rmsnorm(k, k_scale)): the qk-norm, one launch."""
    fn = _norm.rmsnorm_pair if _route(q) else _norm.rmsnorm_pair_plain
    return fn(q, k, q_scale, k_scale, eps)


def add_rmsnorm(x, y, scale, eps: float = 1e-6):
    """(x + y, rmsnorm(x + y, scale)): a residual add and the next norm."""
    fn = _norm.add_rmsnorm if _route(x) else _norm.add_rmsnorm_plain
    return fn(x, y, scale, eps)


def gated_rmsnorm(y, z, scale, eps: float = 1e-6):
    """rmsnorm(y * silu(z), scale): Mamba2's gated output norm."""
    fn = _norm.gated_rmsnorm if _route(y) else _norm.gated_rmsnorm_plain
    return fn(y, z, scale, eps)


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale,
                    softcap=0.0, k_cache=None, v_cache=None, cache_pos=None):
    """(B,S,Hq,D) x (B,C,Hkv,D) -> (B,S,Hq,D) under position masks; with
    a ring (``k_cache``/``v_cache`` (B,n,Hkv,D), ``cache_pos`` (B,n)) its
    slots are keys ahead of the chunk's."""
    fn = _flash.flash_attention if _route(q) else _flash.flash_attention_plain
    return fn(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
              window=window, scale=scale, softcap=softcap, k_cache=k_cache,
              v_cache=v_cache, cache_pos=cache_pos)


def decode_attention(q, k_cache, v_cache, *, cache_len, pos=None, window=0,
                     scale, softcap=0.0):
    """(B,1,Hq,D) over (B,n,Hkv,D) caches with per-lane lengths."""
    fn = (_decode.decode_attention if _route(q)
          else _decode.decode_attention_plain)
    return fn(q, k_cache, v_cache, cache_len=cache_len, pos=pos,
              window=window, scale=scale, softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, pos_pages, tables, *,
                           cache_len, window=0, scale, softcap=0.0):
    """(B,1,Hq,D) over (P,page,Hkv,D) pools through (B,maxp) block tables
    with per-lane lengths."""
    fn = (_paged.paged_decode_attention if _route(q)
          else _paged.paged_decode_attention_plain)
    return fn(q, k_pages, v_pages, pos_pages, tables, cache_len=cache_len,
              window=window, scale=scale, softcap=softcap)


def ssd(x, dt, a_log, b_mat, c_mat, d_skip=None, chunk=128):
    """Zero-state chunked SSD scan: (B,S,H,P) in x's dtype."""
    fn = _ssd.ssd if _route(x) else _ssd.ssd_plain
    return fn(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)


def rglru(x, log_a, gate_x):
    """Zero-state RG-LRU scan over (B,S,D), in x's dtype."""
    fn = _rglru.rglru if _route(x) else _rglru.rglru_plain
    return fn(x, log_a, gate_x)


# model functions, not TPU kernels (jnp in the JAX package too): plain
# PyTorch on every device
ssd_decode_step = ref.ssd_decode_step
rglru_decode_step = ref.rglru_decode_step
causal_conv1d = ref.causal_conv1d
causal_conv1d_step = ref.causal_conv1d_step


_COUNTED = {"decode_attention": _decode, "flash_attention": _flash,
            "rmsnorm": _norm, "paged_decode_attention": _paged, "ssd": _ssd,
            "rglru": _rglru}


def kernel_launches() -> dict:
    """Launch counts of the six kernels (plain-version calls excluded)."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_kernel_launches() -> None:
    for mod in _COUNTED.values():
        with mod._count_lock:
            mod.launches = 0

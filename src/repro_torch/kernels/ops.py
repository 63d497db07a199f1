"""Kernel entry points the model calls, dispatched by tensor device only.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
Hopper kernel, which launches or raises.  There is no environment switch
and no fallback from a failed kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _norm


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


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale,
                    softcap=0.0):
    """(B,S,Hq,D) x (B,T,Hkv,D) -> (B,S,Hq,D) under position masks."""
    fn = _flash.flash_attention if _route(q) else _flash.flash_attention_plain
    return fn(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
              window=window, scale=scale, softcap=softcap)


def decode_attention(q, k_cache, v_cache, *, cache_len, pos=None, window=0,
                     scale, softcap=0.0):
    """(B,1,Hq,D) over (B,n,Hkv,D) caches with per-lane lengths."""
    fn = (_decode.decode_attention if _route(q)
          else _decode.decode_attention_plain)
    return fn(q, k_cache, v_cache, cache_len=cache_len, pos=pos,
              window=window, scale=scale, softcap=softcap)


def kernel_launches() -> dict:
    """Launch counts of the three kernels (plain-version calls excluded)."""
    return {"decode_attention": _decode.launches,
            "flash_attention": _flash.launches, "rmsnorm": _norm.launches}


def reset_kernel_launches() -> None:
    for mod in (_decode, _flash, _norm):
        with mod._count_lock:
            mod.launches = 0

"""Self- and cross-attention with GQA, qk-norm, rope and sliding windows.

The heavy math goes through ``repro_torch.kernels.ops``: the Hopper flash
and decode kernels on the card, their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import GLOBAL, LOCAL, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import rope as rope_lib


def _window_for(cfg: ModelConfig, attn_kind: str) -> int:
    """Effective sliding window: 0 means full attention."""
    if attn_kind == LOCAL and cfg.sliding_window:
        return cfg.sliding_window
    if attn_kind == GLOBAL:
        return 0
    return cfg.sliding_window


def _rope_theta_for(cfg: ModelConfig, attn_kind: str) -> float:
    if attn_kind == LOCAL and cfg.local_rope_theta:
        return cfg.local_rope_theta
    return cfg.rope_theta


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale or cfg.resolved_head_dim ** -0.5


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, hd) -> (B, S, H, hd)."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d)."""
    b, s = out.shape[0], out.shape[1]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def shared(memo, key, fn):
    """``fn()`` computed once per model call: ``memo`` is a dict the model
    function creates for one call and hands to every layer, so values that
    depend only on the call's positions (rope tables, ring slots) are not
    rebuilt, and relaunched, in each of the layers.  ``None`` computes."""
    if memo is None:
        return fn()
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _project_qkv(p, x, cfg: ModelConfig, positions, attn_kind: str,
                 memo=None):
    """q, k, v of x (B, S, d): projection, then qk-norm, then rope at
    ``positions`` ((S,) or (B, S))."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.use_qk_norm:
        # qk-norm: q's and k's trailing head_dim, each with its own gain,
        # in one launch on the card
        q, k = ops.rmsnorm_pair(q, k, p["q_norm"], p["k_norm"], cfg.norm_eps)
    theta = _rope_theta_for(cfg, attn_kind)
    cos, sin = shared(memo, ("rope", theta), lambda: rope_lib.rope_freqs(
        cfg.resolved_head_dim, theta, positions))
    return rope_lib.apply_rope(q, cos, sin), rope_lib.apply_rope(k, cos, sin), v


def self_attention(p, x, cfg: ModelConfig, attn_kind: str = GLOBAL,
                   positions=None, return_kv: bool = False, memo=None):
    """Full-sequence causal attention (prefill) through the flash kernel
    with ``q_pos = k_pos = positions``."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, attn_kind, memo)
    out = ops.flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=True, window=_window_for(cfg, attn_kind),
                              scale=_scale(cfg), softcap=cfg.logit_softcap)
    y = _out_proj(out, p["wo"])
    if return_kv:
        return y, (k, v)
    return y


# ------------------------------------------------------------------ cross-attn
def _enc_proj(p, enc, cfg: ModelConfig):
    """K and V projections of ``enc`` cast to ``cfg.dtype`` (no norm)."""
    enc = enc.to(cfg.dtype)
    return _proj(enc, p["wk"]), _proj(enc, p["wv"])


def cross_kv(p, enc, cfg: ModelConfig):
    """Encoder K/V (B, T, Hkv, hd) of ``enc`` (B, T, d) in ``cfg.dtype``,
    k qk-normed where the config says so; no rope (llama-3.2-vision's
    cross layers rotate nothing).  ``enc`` is cast to ``cfg.dtype`` first;
    where the reference is handed a wider ``enc`` its einsum promotes."""
    k, v = _enc_proj(p, enc, cfg)
    if cfg.use_qk_norm:
        k = ops.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def cross_attention(p, x, enc, cfg: ModelConfig, kv_cached=None, memo=None):
    """Attention of x (B, S, d) over encoder states: every key is visible
    to every query (no causal mask, no window, no rope).  K/V come from
    ``enc`` (B, T, d), or from ``kv_cached`` ((B, T, Hkv, hd) each, as
    ``cross_kv`` gives them).  Returns (y, (k, v)).

    The keys go through the flash kernel with ``causal=False`` and
    ``k_pos = arange(T)`` (``q_pos`` is read by no mask).  A one-token
    query over cached K/V (the decode step) goes through the decode kernel
    in its contiguous form instead (``pos=None``, ``cache_len = T`` on
    every lane): the same softmax over all T keys, with one block holding
    a whole GQA group where flash's 64-row tile would sit mostly empty."""
    q = _proj(x, p["wq"])
    if kv_cached is None:
        k, v = _enc_proj(p, enc, cfg)
        if cfg.use_qk_norm:
            # q and k normed in one launch on the card
            q, k = ops.rmsnorm_pair(q, k, p["q_norm"], p["k_norm"],
                                    cfg.norm_eps)
    else:
        k, v = (t.to(x.dtype) for t in kv_cached)
        if cfg.use_qk_norm:
            q = ops.rmsnorm(q, p["q_norm"], cfg.norm_eps)
    b, s, t = x.shape[0], x.shape[1], k.shape[1]
    if s == 1 and kv_cached is not None:
        cl = shared(memo, ("enc_len", b, t), lambda: torch.full(
            (b,), t, dtype=torch.int32, device=x.device))
        out = ops.decode_attention(q, k, v, cache_len=cl, pos=None,
                                   scale=_scale(cfg),
                                   softcap=cfg.logit_softcap)
    else:
        kp = shared(memo, ("enc_pos", t), lambda: torch.arange(
            t, dtype=torch.int32, device=x.device))
        qp = shared(memo, ("enc_qpos", s), lambda: torch.zeros(
            s, dtype=torch.int32, device=x.device))
        out = ops.flash_attention(q, k, v, q_pos=qp, k_pos=kp, causal=False,
                                  window=0, scale=_scale(cfg),
                                  softcap=cfg.logit_softcap)
    return _out_proj(out, p["wo"]), (k, v)

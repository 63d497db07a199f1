"""Self-attention with GQA, qk-norm, rope and sliding windows.

The heavy math goes through ``repro_torch.kernels.ops``: the Hopper flash
kernel on the card, its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import GLOBAL, LOCAL, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import rmsnorm_headwise


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
        q = rmsnorm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_headwise(p["k_norm"], k, cfg.norm_eps)
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

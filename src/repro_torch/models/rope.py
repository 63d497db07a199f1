"""Rotary position embeddings (rotate-half) with float32 angles and
per-layer base switching (gemma3-style local layers may use a smaller
base than global layers)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) integer -> cos/sin of shape positions.shape +
    (head_dim / 2,), float32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:               # (S, half) -> broadcast batch/head
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                            # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)

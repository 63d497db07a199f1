"""Griffin / RecurrentGemma recurrent block: the port of
``repro.models.rglru``.

proj -> causal conv -> RG-LRU, gated by a parallel GeLU branch, then the
out-projection.  The scan goes through ``ops.rglru`` (the Hopper kernel on
the card, ``ref.rglru_chunked`` on the CPU); the decode step and the conv
are plain PyTorch on both.

Numerics follow the reference: the gates are float32, rounded to the
compute dtype only where they enter the scan, while the incoming state's
term ``exp(cumsum log_a) h0`` uses the float32 ``log_a``.  A layer's cache
is ``{"conv": (B, W-1, width) raw conv inputs in cfg.dtype, "h": (B,
width) float32}``; the functions that take one update its entries and
return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops

# leaves the reference reads in float32 (stored in float32 here too)
F32_LEAVES = ("conv_w", "conv_b", "b_a", "b_i", "lam")


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, w = cfg.d_model, cfg.rglru_width
    return {"w_x": (d, w), "w_y": (d, w), "conv_w": (cfg.conv_width, w),
            "conv_b": (w,), "w_a": (w, w), "b_a": (w,), "w_i": (w, w),
            "b_i": (w,), "lam": (w,), "w_out": (w, d)}


def lam_init(cfg: ModelConfig, device) -> torch.Tensor:
    """The reference's Lambda: a^c = exp(-c softplus(Lambda)) spans
    (0.9, 0.999) across the channels."""
    a = torch.linspace(0.9, 0.999, cfg.rglru_width, dtype=torch.float32,
                       device=device)
    return torch.log(torch.expm1(-torch.log(a) / cfg.rglru_c))


def _gates(p, u, cfg: ModelConfig):
    """u: (..., W) conv output -> (log_a, gate_i), both float32."""
    f32 = torch.float32
    r = torch.sigmoid((u @ p["w_a"]).to(f32) + p["b_a"].to(f32))
    i = torch.sigmoid((u @ p["w_i"]).to(f32) + p["b_i"].to(f32))
    log_a = -cfg.rglru_c * F.softplus(p["lam"].to(f32)) * r
    return log_a, i


def _branches(p, x):
    return x @ p["w_x"], F.gelu(x @ p["w_y"], approximate="tanh")


def rglru_block(p, x, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence Griffin recurrent block.  x: (B, S, d_model).  With
    ``return_state`` also the decode cache after the sequence (its ``h`` is
    the scan's last output, rounded to the compute dtype, as in the
    reference)."""
    dtype = x.dtype
    u, gate = _branches(p, x)
    u_conv = ops.causal_conv1d(u, p["conv_w"], p["conv_b"])
    log_a, gate_i = _gates(p, u_conv, cfg)
    h = ops.rglru(u_conv, log_a.to(dtype), gate_i.to(dtype))
    out = (h * gate) @ p["w_out"]
    if return_state:
        w = cfg.conv_width - 1
        s = u.shape[1]
        tail = u[:, max(s - w, 0):]
        if s < w:
            tail = F.pad(tail, (0, 0, w - s, 0))
        return out, {"conv": tail.contiguous(),
                     "h": h[:, -1].to(torch.float32)}
    return out


def rglru_prefill_chunk(p, x, cache, cfg: ModelConfig):
    """Run prompt chunk x ((B, C, d_model)) from the incoming cache and
    leave the post-chunk state in it: the conv is seeded with the cached
    raw-input tail, and the recurrence is the zero-state scan plus
    ``exp(cumsum log_a) h0`` (the gates do not depend on h0), so chunks
    compose to the full-sequence recurrence."""
    dtype = x.dtype
    f32 = torch.float32
    w = cfg.conv_width - 1
    u, gate = _branches(p, x)
    conv_in = torch.cat([cache["conv"].to(dtype), u], dim=1)
    new_conv = conv_in[:, conv_in.shape[1] - w:]
    u_conv = ops.causal_conv1d(conv_in, p["conv_w"],
                               p["conv_b"])[:, w:].contiguous()
    log_a, gate_i = _gates(p, u_conv, cfg)
    h_local = ops.rglru(u_conv, log_a.to(dtype), gate_i.to(dtype))
    carry = torch.exp(torch.cumsum(log_a, dim=1)) * cache["h"][:, None, :]
    h = h_local.to(f32) + carry
    cache["conv"] = new_conv.to(cache["conv"].dtype)
    cache["h"] = h[:, -1]
    return (h.to(dtype) * gate) @ p["w_out"], cache


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    w = cfg.rglru_width
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cfg.dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x, cache, cfg: ModelConfig):
    """One token per lane.  x: (B, 1, d_model) -> (y (B, 1, d_model), the
    cache with every lane's state advanced)."""
    dtype = x.dtype
    u, gate = _branches(p, x[:, 0])
    u_conv, cache["conv"] = ops.causal_conv1d_step(cache["conv"], u,
                                                   p["conv_w"], p["conv_b"])
    log_a, gate_i = _gates(p, u_conv, cfg)
    y, cache["h"] = ops.rglru_decode_step(cache["h"], u_conv, log_a, gate_i)
    return ((y.to(dtype) * gate) @ p["w_out"])[:, None], cache

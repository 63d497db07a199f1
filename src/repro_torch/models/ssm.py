"""Mamba2 (SSD, state-space duality) mixer: the port of
``repro.models.ssm``.

Fused in-projection to (z, x, B, C, dt), a short causal depthwise conv over
(x, B, C), softplus dt, a per-head scalar A, the SSD scan, a gated RMSNorm
and the out-projection.  The scan goes through ``ops.ssd`` (the Hopper
kernel on the card, ``ref.ssd_chunked`` on the CPU); the decode step and
the conv are plain PyTorch on both, as they are jnp in the JAX package.

Numerics follow the reference: dt is rounded to the compute dtype only
where it enters the scan, while the incoming-state term and the final
state use the float32 dt; the scan's output is rounded to the compute
dtype before the carried-state term is added in float32.  A layer's cache
is ``{"conv": (B, W-1, conv_dim) raw conv inputs in cfg.dtype, "state":
(B, H, N, P) float32}``; the functions that take one update its entries
and return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops

# leaves the reference reads in float32 (stored in float32 here too)
F32_LEAVES = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm")


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_d_inner
    n_heads = cfg.ssm_heads
    n_state = cfg.ssm_state
    conv_dim = d_inner + 2 * n_state
    d_in_proj = 2 * d_inner + 2 * n_state + n_heads
    return d_inner, n_heads, n_state, conv_dim, d_in_proj


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The mixer's leaves; ``norm`` is the gated norm's gain (the JAX
    tree's ``norm/scale``)."""
    d_inner, n_heads, _, conv_dim, d_in_proj = _dims(cfg)
    return {"in_proj": (cfg.d_model, d_in_proj),
            "conv_w": (cfg.conv_width, conv_dim), "conv_b": (conv_dim,),
            "dt_bias": (n_heads,), "a_log": (n_heads,), "d_skip": (n_heads,),
            "norm": (d_inner,), "out_proj": (d_inner, cfg.d_model)}


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_inner, _, _, conv_dim, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def _ssd_chunk(s: int, cfg: ModelConfig) -> int:
    """The reference's scan chunk: ``min(ssm_chunk, s)``, halved while it
    does not divide ``s`` (a 100-token prompt scans in one chunk of 100, a
    130-token one in chunks of 2)."""
    chunk = min(cfg.ssm_chunk, s)
    while s % chunk:
        chunk //= 2
    return max(chunk, 1)


def _scan_inputs(xbc, cfg: ModelConfig):
    """Conv output (B, S, conv_dim) -> xs (B, S, H, P), B and C (B, S, N),
    each contiguous for the kernel."""
    d_inner, n_heads, n_state, _, _ = _dims(cfg)
    b, s, _ = xbc.shape
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, cfg.ssm_head_dim)
    b_mat = xbc[..., d_inner:d_inner + n_state]
    c_mat = xbc[..., d_inner + n_state:]
    return xs.contiguous(), b_mat.contiguous(), c_mat.contiguous()


def _gated_out(p, y, z, cfg: ModelConfig):
    """The gated norm ``rmsnorm(y * silu(z))`` (one launch on the card; z is
    read in place from the projection) and the out-projection."""
    return ops.gated_rmsnorm(y, z, p["norm"], cfg.norm_eps) @ p["out_proj"]


def ssm_mixer(p, x, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence SSD mixer.  x: (B, S, d_model).  With
    ``return_state`` also the decode cache after the sequence."""
    b, s, _ = x.shape
    d_inner = cfg.ssm_d_inner
    dtype = x.dtype
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = F.silu(ops.causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs, b_mat, c_mat = _scan_inputs(xbc, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y = ops.ssd(xs, dt.to(dtype), p["a_log"], b_mat, c_mat, p["d_skip"],
                chunk=_ssd_chunk(s, cfg))
    out = _gated_out(p, y.reshape(b, s, d_inner), z, cfg)
    if return_state:
        return out, {"conv": _tail_conv_state(zxbcdt, cfg),
                     "state": _final_ssd_state(xs, dt, p["a_log"], b_mat)}
    return out


def _tail_conv_state(zxbcdt, cfg: ModelConfig):
    """The last (conv_width - 1) raw conv inputs, zero-padded on the left."""
    _, xbc, _ = _split_proj(zxbcdt, cfg)
    w = cfg.conv_width - 1
    s = xbc.shape[1]
    tail = xbc[:, max(s - w, 0):]
    if s < w:
        tail = F.pad(tail, (0, 0, w - s, 0))
    return tail.contiguous()


def _final_ssd_state(xs, dt, a_log, b_mat):
    """The SSD state after the sequence from a zero state, (B, H, N, P)
    float32: ``sum_s exp(cum_S - cum_s) B_s (x dt)_s^T``."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    cum = torch.cumsum(dt.to(f32) * a[None, None, :], dim=1)     # (B,S,H)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)
    xb = xs.to(f32) * (dt.to(f32) * decay_to_end)[..., None]      # (B,S,H,P)
    return torch.einsum("bsn,bshp->bhnp", b_mat.to(f32), xb)


def ssm_prefill_chunk(p, x, cache, cfg: ModelConfig):
    """Run prompt chunk x ((B, C, d_model)) from the incoming cache and
    leave the post-chunk state in it.  The conv is seeded with the cached
    raw-input tail; the output is the zero-state scan plus the incoming
    state's decayed term ``C_t exp(cum_t) h0``, and the new state is
    ``exp(total) h0`` plus the chunk's own final state, so chunks compose
    to the full-sequence recurrence."""
    b, c, _ = x.shape
    d_inner = cfg.ssm_d_inner
    dtype = x.dtype
    f32 = torch.float32
    w = cfg.conv_width - 1
    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([cache["conv"].to(dtype), xbc_raw], dim=1)
    new_conv = conv_in[:, conv_in.shape[1] - w:]
    xbc = F.silu(ops.causal_conv1d(conv_in, p["conv_w"], p["conv_b"])[:, w:])
    xs, b_mat, c_mat = _scan_inputs(xbc, cfg)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    y = ops.ssd(xs, dt.to(dtype), p["a_log"], b_mat, c_mat, p["d_skip"],
                chunk=_ssd_chunk(c, cfg))
    a = -torch.exp(p["a_log"].to(f32))
    cum = torch.cumsum(dt * a[None, None, :], dim=1)              # (B,C,H)
    h0 = cache["state"]                                           # (B,H,N,P)
    y_carry = (torch.einsum("bsn,bhnp->bshp", c_mat.to(f32), h0)
               * torch.exp(cum)[..., None])
    y = y.to(f32) + y_carry
    cache["state"] = (torch.exp(cum[:, -1])[..., None, None] * h0
                      + _final_ssd_state(xs, dt, p["a_log"], b_mat))
    cache["conv"] = new_conv.to(cache["conv"].dtype)
    return _gated_out(p, y.reshape(b, c, d_inner).to(dtype), z, cfg), cache


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    d_inner, n_heads, n_state, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
        "state": torch.zeros((batch, n_heads, n_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p, x, cache, cfg: ModelConfig):
    """One token per lane.  x: (B, 1, d_model) -> (y (B, 1, d_model), the
    cache with every lane's state advanced)."""
    b = x.shape[0]
    d_inner, n_heads, n_state, _, _ = _dims(cfg)
    z, xbc, dt_raw = _split_proj(x[:, 0] @ p["in_proj"], cfg)
    xbc, cache["conv"] = ops.causal_conv1d_step(cache["conv"], xbc,
                                                p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(b, n_heads, cfg.ssm_head_dim)
    b_t = xbc[..., d_inner:d_inner + n_state]
    c_t = xbc[..., d_inner + n_state:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    y, cache["state"] = ops.ssd_decode_step(cache["state"], xs, dt,
                                            p["a_log"], b_t, c_t,
                                            p["d_skip"])
    return _gated_out(p, y.reshape(b, d_inner), z, cfg)[:, None], cache

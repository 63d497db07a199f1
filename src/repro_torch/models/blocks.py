"""Decoder blocks: pre-RMSNorm self-attention + dense MLP, with residuals.

``Block`` holds one layer's parameters.  Its entry points mirror the JAX
package's ``models/blocks.py``:

  apply_block(...)               -> (y, aux)        (forward / prefill)
  apply_block_prefill(...)       -> (y, cache, aux) (whole-prompt prefill)
  apply_block_prefill_chunk(...) -> (y, cache, aux) (chunked prefill)
  apply_block_decode(...)        -> (y, cache, aux) (one token per lane)
  init_block_cache(...)          -> cache dict

A layer's cache is a dict ``{"k", "v": (B, n, Hkv, D), "pos": (B, n) int32}``
(-1 = empty slot), the JAX per-layer layout.  Where JAX returns new cache
arrays, these functions update the cache **in place** (``index_put_``) and
return the same dict: a decode step then writes one row per lane instead of
copying every layer's KV.

Only self-attention (global and sliding-window) blocks with a dense MLP are
ported; the other kinds raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.common.config import ATTN, CROSS, LOCAL, RGLRU, SSM, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import mlp, rmsnorm

_LATER = {
    SSM: "ROADMAP.md section 2 item 3 (recurrent stacks)",
    RGLRU: "ROADMAP.md section 2 item 3 (recurrent stacks)",
    CROSS: "ROADMAP.md section 2 item 5 (cross-attention)",
}


def _not_ported(kind: str):
    return NotImplementedError(
        f"{kind!r} blocks are not ported yet: {_LATER.get(kind, 'ROADMAP.md')}")


def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's parameters (stored in ``cfg.dtype``; the norm
    gains in float32, as the reference reads them)."""

    def __init__(self, cfg: ModelConfig, kind: str, attn_kind: str, device):
        super().__init__()
        if kind != ATTN:
            raise _not_ported(kind)
        if cfg.num_experts:
            raise NotImplementedError(
                "MoE layers are not ported yet: ROADMAP.md section 2 item 4")
        self.kind, self.attn_kind = kind, attn_kind
        d, h, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
        dt, f32 = cfg.dtype, torch.float32
        self.norm1 = _param((d,), f32, device, 0.0)
        attn = {"wq": _param((d, h, hd), dt, device),
                "wk": _param((d, hkv, hd), dt, device),
                "wv": _param((d, hkv, hd), dt, device),
                "wo": _param((h, hd, d), dt, device)}
        if cfg.use_qk_norm:
            attn["q_norm"] = _param((hd,), f32, device, 0.0)
            attn["k_norm"] = _param((hd,), f32, device, 0.0)
        self.attn = nn.ParameterDict(attn)
        self.norm2 = None
        self.mlp = None
        if cfg.d_ff > 0:
            f = cfg.d_ff
            self.norm2 = _param((d,), f32, device, 0.0)
            m = {"w_up": _param((d, f), dt, device),
                 "w_down": _param((f, d), dt, device)}
            if cfg.mlp_kind in ("swiglu", "geglu"):
                m["w_gate"] = _param((d, f), dt, device)
            self.mlp = nn.ParameterDict(m)


def _channel_mix(p: Block, x, cfg: ModelConfig):
    """Pre-norm dense MLP with residual; the aux (MoE balance) loss of a
    dense layer is 0.0."""
    if p.mlp is None:
        return x, 0.0
    h = rmsnorm(p.norm2, x, cfg.norm_eps)
    return x + mlp(p.mlp, h, cfg.mlp_kind), 0.0


# -------------------------------------------------------------- train/prefill
def apply_block(p: Block, x, cfg: ModelConfig, kind: str, attn_kind: str, *,
                positions=None, memo=None):
    if kind != ATTN:
        raise _not_ported(kind)
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    x = x + attn_lib.self_attention(p.attn, h, cfg, attn_kind, positions,
                                    memo=memo)
    return _channel_mix(p, x, cfg)


# --------------------------------------------------------------------- caches
def _attn_cache_len(cfg: ModelConfig, attn_kind: str, capacity: int) -> int:
    if attn_kind == LOCAL and cfg.sliding_window:
        return min(capacity, cfg.sliding_window)
    return capacity


def init_block_cache(cfg: ModelConfig, kind: str, attn_kind: str, batch: int,
                     capacity: int, device) -> Dict[str, torch.Tensor]:
    if kind != ATTN:
        raise _not_ported(kind)
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    n = _attn_cache_len(cfg, attn_kind, capacity)
    return {
        "k": torch.zeros((batch, n, hkv, hd), dtype=cfg.dtype, device=device),
        "v": torch.zeros((batch, n, hkv, hd), dtype=cfg.dtype, device=device),
        # per-lane ring-slot absolute positions (-1 = empty)
        "pos": torch.full((batch, n), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------- decode
def apply_block_decode(p: Block, x, cache, cfg: ModelConfig, kind: str,
                       attn_kind: str, *, cache_index, block_tables=None,
                       memo=None):
    """x: (B, 1, d).  Lane b writes its new K/V into ring slot
    ``cache_index[b] % n`` (in place) and attends over its own ring through
    the decode kernel with the ``pos`` plane.  Every lane is written,
    free lanes included; ``Replica._insert`` overwrites a joining lane's
    whole ring, ``pos`` too, so those writes never leak."""
    if kind != ATTN:
        raise _not_ported(kind)
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV decode is not ported yet: ROADMAP.md section 2 item 1")
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    b = x.shape[0]
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
    idx = idx.expand(b).contiguous() if idx.dim() == 0 else idx
    q, k, v = attn_lib._project_qkv(p.attn, h, cfg, idx[:, None], attn_kind,
                                    memo)
    n = cache["k"].shape[1]
    lanes = attn_lib.shared(memo, "lanes",
                            lambda: torch.arange(b, device=x.device))
    slots = attn_lib.shared(memo, ("slots", n), lambda: (idx % n).long())
    cache["k"][lanes, slots] = k[:, 0].to(cache["k"].dtype)
    cache["v"][lanes, slots] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][lanes, slots] = idx
    out = ops.decode_attention(
        q, cache["k"], cache["v"],
        cache_len=attn_lib.shared(memo, "cache_len", lambda: idx + 1),
        pos=cache["pos"],
        window=attn_lib._window_for(cfg, attn_kind),
        scale=attn_lib._scale(cfg), softcap=cfg.logit_softcap)
    x = x + attn_lib._out_proj(out, p.attn["wo"])
    x, aux = _channel_mix(p, x, cfg)
    return x, cache, aux


# -------------------------------------------------------------------- prefill
def apply_block_prefill(p: Block, x, cfg: ModelConfig, kind: str,
                        attn_kind: str, *, positions=None, capacity: int = 0,
                        memo=None):
    """Like ``apply_block`` but also returns a new decode cache holding the
    prompt's last ``min(S, n)`` keys in ring slots ``pos % n``."""
    if kind != ATTN:
        raise _not_ported(kind)
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    b, s, _ = x.shape
    y, (k, v) = attn_lib.self_attention(p.attn, h, cfg, attn_kind, positions,
                                        return_kv=True, memo=memo)
    x = x + y
    cache = init_block_cache(cfg, kind, attn_kind, b, capacity, x.device)
    n = cache["k"].shape[1]
    take = min(s, n)
    src = torch.arange(s - take, s, dtype=torch.int32, device=x.device)
    slots = (src % n).long()
    cache["k"][:, slots] = k[:, s - take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - take:].to(cache["v"].dtype)
    cache["pos"][:, slots] = src
    x, aux = _channel_mix(p, x, cfg)
    return x, cache, aux


# ------------------------------------------------------------ chunked prefill
def apply_block_prefill_chunk(p: Block, x, cache, cfg: ModelConfig, kind: str,
                              attn_kind: str, *, start, memo=None):
    """Extend a decode cache with a prompt chunk x (B, C, d) at absolute
    positions [start, start + C).  The chunk's queries attend over
    ``[ring ‖ chunk]`` through the flash kernel (k_pos = the ring's pos
    plane followed by the chunk's positions) **before** the chunk's K/V is
    scattered into the ring, so a chunk that wraps the ring cannot
    overwrite keys its own queries still need.  The ring is updated in
    place."""
    if kind != ATTN:
        raise _not_ported(kind)
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    b, c, _ = x.shape
    n = cache["k"].shape[1]
    positions = attn_lib.shared(memo, "positions", lambda: torch.arange(
        int(start), int(start) + c, dtype=torch.int32, device=x.device))
    q, k, v = attn_lib._project_qkv(p.attn, h, cfg, positions, attn_kind,
                                    memo)
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    k_cat = torch.cat([cache["k"], k], dim=1)
    v_cat = torch.cat([cache["v"], v], dim=1)
    pos_cat = torch.cat([cache["pos"], positions.expand(b, c)], dim=1)
    out = ops.flash_attention(
        q, k_cat, v_cat, q_pos=positions, k_pos=pos_cat, causal=True,
        window=attn_lib._window_for(cfg, attn_kind),
        scale=attn_lib._scale(cfg), softcap=cfg.logit_softcap)
    # now scatter the chunk's last min(C, n) keys into the ring (older ones
    # are already beyond the ring and can never be read)
    take = min(c, n)
    src = positions[c - take:]
    slots = (src % n).long()
    cache["k"][:, slots] = k[:, c - take:]
    cache["v"][:, slots] = v[:, c - take:]
    cache["pos"][:, slots] = src
    x = x + attn_lib._out_proj(out, p.attn["wo"])
    x, aux = _channel_mix(p, x, cfg)
    return x, cache, aux

"""Decoder blocks: a pre-RMSNorm temporal mixer (self-attention,
cross-attention, SSD or RG-LRU) and a pre-RMSNorm channel mixer (dense MLP
or MoE FFN), with residuals.

``Block`` holds one layer's parameters.  Its entry points mirror the JAX
package's ``models/blocks.py``:

  apply_block(...)               -> (y, aux)        (forward / prefill)
  apply_block_prefill(...)       -> (y, cache, aux) (whole-prompt prefill)
  apply_block_prefill_chunk(...) -> (y, cache, aux) (chunked prefill)
  apply_block_decode(...)        -> (y, cache, aux) (one token per lane)
  init_block_cache(...)          -> cache dict

A layer's cache is a dict ``{"k", "v": (B, n, Hkv, D), "pos": (B, n) int32}``
(-1 = empty slot), the JAX per-layer layout; in paged mode it is a page
pool ``{"k", "v": (P, page, Hkv, D), "pos": (P, page)}`` read through
per-lane block tables.  Where JAX returns new cache
arrays, these functions update the cache **in place** (``index_put_``) and
return the same dict: a decode step then writes one row per lane instead of
copying every layer's KV.

A recurrent layer's cache is its mixer's state: ``{"conv", "state"}`` for
an SSD (Mamba2) block, ``{"conv", "h"}`` for an RG-LRU (Griffin) block,
batch-major in ring and paged mode alike (block tables do not apply).
A cross-attention layer's cache is the encoder's K/V, ``{"k", "v": (B, T,
Hkv, D)}`` with no ``pos``: whole-prompt prefill fills it from ``enc``,
and a decode step reads it without writing it.  Chunked prefill refuses
cross layers, as the reference does (``model.chunked_prefill_caps``).

Attention and cross-attention blocks of a config with ``num_experts``
take the mixture-of-experts FFN (``models.moe``) as their channel mixer.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch
from torch import nn

from repro_torch.common.config import ATTN, CROSS, LOCAL, RGLRU, SSM, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.serving import spmd_decode as spmd
from repro_torch.sharding import context as shctx

def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def _mixer_params(shapes, f32_leaves, cfg: ModelConfig, device):
    """A recurrent mixer's leaves: those the reference reads in float32
    (conv taps and biases, decay and skip parameters, norm gains) stored in
    float32, the projections in ``cfg.dtype``."""
    return nn.ParameterDict({
        name: _param(shape, torch.float32 if name in f32_leaves else cfg.dtype,
                     device)
        for name, shape in shapes.items()})


class Block(nn.Module):
    """One decoder layer's parameters (stored in ``cfg.dtype``; the leaves
    the reference reads in float32, norm gains included, in float32).
    ``attn`` (self- or cross-attention, the same leaves), ``ssm`` or
    ``rec`` holds the temporal mixer, by kind."""

    def __init__(self, cfg: ModelConfig, kind: str, attn_kind: str, device):
        super().__init__()
        if kind not in (ATTN, CROSS, SSM, RGLRU):
            raise ValueError(kind)
        self.kind, self.attn_kind = kind, attn_kind
        d, h, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
        dt, f32 = cfg.dtype, torch.float32
        self.norm1 = _param((d,), f32, device, 0.0)
        self.attn = self.ssm = self.rec = None
        if kind == SSM:
            self.ssm = _mixer_params(ssm_lib.param_shapes(cfg),
                                     ssm_lib.F32_LEAVES, cfg, device)
        elif kind == RGLRU:
            self.rec = _mixer_params(rglru_lib.param_shapes(cfg),
                                     rglru_lib.F32_LEAVES, cfg, device)
        else:
            attn = {"wq": _param((d, h, hd), dt, device),
                    "wk": _param((d, hkv, hd), dt, device),
                    "wv": _param((d, hkv, hd), dt, device),
                    "wo": _param((h, hd, d), dt, device)}
            if cfg.use_qk_norm:
                attn["q_norm"] = _param((hd,), f32, device, 0.0)
                attn["k_norm"] = _param((hd,), f32, device, 0.0)
            self.attn = nn.ParameterDict(attn)
        self.norm2 = self.mlp = self.moe = None
        if cfg.num_experts and kind in (ATTN, CROSS):
            self.norm2 = _param((d,), f32, device, 0.0)
            self.moe = Experts(cfg, device)
        elif cfg.d_ff > 0:
            self.norm2 = _param((d,), f32, device, 0.0)
            self.mlp = _mlp_params(cfg, cfg.d_ff, device)


def _mlp_params(cfg: ModelConfig, f: int, device) -> nn.ParameterDict:
    d, dt = cfg.d_model, cfg.dtype
    m = {"w_up": _param((d, f), dt, device),
         "w_down": _param((f, d), dt, device)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        m["w_gate"] = _param((d, f), dt, device)
    return nn.ParameterDict(m)


class Experts(nn.Module):
    """An MoE layer's leaves in ``cfg.dtype``, read by name as a dict's
    (``p["router"]``): ``router`` (d, E), ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d) and, with ``moe_dense_ff``, the ``dense`` MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        for name, shape in moe_lib.param_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.dtype, device))
        self.dense = (_mlp_params(cfg, cfg.moe_dense_ff, device)
                      if cfg.moe_dense_ff else None)

    def __getitem__(self, name: str):
        return getattr(self, name)


def _channel_mix(p: Block, x, y, cfg: ModelConfig, num_groups: int = 1):
    """The mixer's residual ``x + y``, then the pre-norm dense MLP or MoE
    FFN (capacity in ``num_groups`` groups) with its residual.  The add and
    the norm are one launch on the card (``add_rmsnorm``).  Returns (x,
    aux): the MoE balance loss, 0.0 for a dense layer."""
    if p.norm2 is None:
        return x + y, 0.0
    x, h = ops.add_rmsnorm(x, y, p.norm2, cfg.norm_eps)
    if p.moe is not None:
        out, aux = moe_lib.moe_ffn(p.moe, h, cfg, num_groups)
        return x + out, aux
    return x + mlp(p.mlp, h, cfg.mlp_kind), 0.0


# -------------------------------------------------------------- train/prefill
def apply_block(p: Block, x, cfg: ModelConfig, kind: str, attn_kind: str, *,
                positions=None, enc=None, memo=None, num_groups: int = 1):
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if kind == ATTN:
        y = attn_lib.self_attention(p.attn, h, cfg, attn_kind, positions,
                                    memo=memo)
    elif kind == CROSS:
        y, _ = attn_lib.cross_attention(p.attn, h, enc, cfg, memo=memo)
    elif kind == SSM:
        y = ssm_lib.ssm_mixer(p.ssm, h, cfg)
    elif kind == RGLRU:
        y = rglru_lib.rglru_block(p.rec, h, cfg)
    else:
        raise ValueError(kind)
    return _channel_mix(p, x, y, cfg, num_groups)


# --------------------------------------------------------------------- caches
def _attn_cache_len(cfg: ModelConfig, attn_kind: str, capacity: int) -> int:
    if attn_kind == LOCAL and cfg.sliding_window:
        return min(capacity, cfg.sliding_window)
    return capacity


def init_block_cache(cfg: ModelConfig, kind: str, attn_kind: str, batch: int,
                     capacity: int, device) -> Dict[str, torch.Tensor]:
    if kind == SSM:
        return ssm_lib.init_ssm_cache(cfg, batch, device)
    if kind == RGLRU:
        return rglru_lib.init_rglru_cache(cfg, batch, device)
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    if kind == CROSS:
        shape = (batch, cfg.num_image_tokens, hkv, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if kind != ATTN:
        raise ValueError(kind)
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
    whole ring, ``pos`` too, so those writes never leak.

    With ``block_tables`` ((B, maxp) int32 page ids, -1 = absent) the cache
    is a paged pool ``{"k"/"v": (P, page, Hkv, D), "pos": (P, page)}``
    shared by all lanes: lane b writes into the pool row its table names
    for position ``cache_index[b]`` (the last, dump row when that entry is
    -1: free and mid-prefill lanes) and attends through the table with the
    paged decode kernel.  Duplicate dump-row writes are harmless: no table
    names the dump row.

    Under a serving mesh (``sharding.context``) an attention block's ring
    or pools are laid out over it (``serving.spmd_decode.Sharded``; a
    plain cache is laid out at its first step, in place of its tensors)
    and attention runs the split-S flash-decode there
    (``spmd_decode_attention`` / ``spmd_paged_decode_attention``), as the
    reference routes it; other blocks are unchanged.

    A recurrent block advances every lane's state by one token (the tables
    do not apply); ``Replica._insert`` and ``paged_commit`` overwrite a
    joining lane's state.  A cross-attention block attends over its cached
    encoder K/V, every slot visible, and writes nothing."""
    if kind in (SSM, RGLRU):
        return _recurrent(p, x, cfg, kind, "decode", cache=cache)
    if kind == CROSS:
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        y, _ = attn_lib.cross_attention(p.attn, h, None, cfg,
                                        kv_cached=(cache["k"], cache["v"]),
                                        memo=memo)
        x, aux = _channel_mix(p, x, y, cfg)
        return x, cache, aux
    if kind != ATTN:
        raise ValueError(kind)
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    b = x.shape[0]
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
    idx = idx.expand(b).contiguous() if idx.dim() == 0 else idx
    q, k, v = attn_lib._project_qkv(p.attn, h, cfg, idx[:, None], attn_kind,
                                    memo)
    lanes = attn_lib.shared(memo, "lanes",
                            lambda: torch.arange(b, device=x.device))
    if block_tables is None:
        n = cache["k"].shape[1]
        rows = lanes
        within = attn_lib.shared(memo, ("slots", n), lambda: (idx % n).long())
    else:
        npool, page = cache["k"].shape[0], cache["k"].shape[1]
        rows, within = attn_lib.shared(
            memo, ("paged_slots", npool, page),
            lambda: _paged_slots(block_tables, idx, lanes, npool, page))
    serving = shctx.get_serving_mesh()
    if serving is not None:
        # split-S flash-decode over the serving mesh: each sequence shard
        # writes the lanes whose slot or pool row it holds and attends
        # over its own slots; one combine joins the shards
        mesh, b_ax, s_ax = serving
        kw = dict(window=attn_lib._window_for(cfg, attn_kind),
                  scale=attn_lib._scale(cfg), softcap=cfg.logit_softcap,
                  batch_axis=b_ax, seq_axis=s_ax, memo=memo)
        if block_tables is None:
            out, *kvp = spmd.spmd_decode_attention(
                mesh, q, cache["k"], cache["v"], k, v, cache["pos"], idx, **kw)
        else:
            out, *kvp = spmd.spmd_paged_decode_attention(
                mesh, q, cache["k"], cache["v"], cache["pos"], block_tables,
                k, v, rows, within, idx, **kw)
        cache.update(zip(("k", "v", "pos"), kvp))
        x, aux = _channel_mix(p, x, attn_lib._out_proj(out, p.attn["wo"]),
                              cfg)
        return x, cache, aux
    cache["k"][rows, within] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, within] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, within] = idx
    kw = dict(cache_len=attn_lib.shared(memo, "cache_len", lambda: idx + 1),
              window=attn_lib._window_for(cfg, attn_kind),
              scale=attn_lib._scale(cfg), softcap=cfg.logit_softcap)
    if block_tables is None:
        out = ops.decode_attention(q, cache["k"], cache["v"],
                                   pos=cache["pos"], **kw)
    else:
        out = ops.paged_decode_attention(q, cache["k"], cache["v"],
                                         cache["pos"], block_tables, **kw)
    x, aux = _channel_mix(p, x, attn_lib._out_proj(out, p.attn["wo"]), cfg)
    return x, cache, aux


# recurrent kind -> the Block field holding its params, and its mixer at
# each entry point (its params and the normed input -> (y, cache))
_RECURRENT = {
    SSM: ("ssm", {"decode": ssm_lib.ssm_decode,
                  "prefill": partial(ssm_lib.ssm_mixer, return_state=True),
                  "chunk": ssm_lib.ssm_prefill_chunk}),
    RGLRU: ("rec", {"decode": rglru_lib.rglru_decode,
                    "prefill": partial(rglru_lib.rglru_block,
                                       return_state=True),
                    "chunk": rglru_lib.rglru_prefill_chunk}),
}


def _recurrent(p: Block, x, cfg: ModelConfig, kind: str, stage: str, **kw):
    """A recurrent block at one entry point (``stage``, a key of
    ``_RECURRENT``): the pre-norm, the kind's mixer, the residual and the
    MLP.  Returns (x, cache, aux)."""
    field, mixers = _RECURRENT[kind]
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    y, cache = mixers[stage](getattr(p, field), h, cfg=cfg, **kw)
    x, aux = _channel_mix(p, x, y, cfg)
    return x, cache, aux


def _paged_slots(tables, idx, lanes, npool: int, page: int):
    """Pool row and in-page slot of each lane's write at position ``idx``:
    ``tables[b, min(idx // page, maxp - 1)]``, or the dump row ``npool - 1``
    where that entry is -1."""
    entry = tables[lanes, (idx // page).clamp_max(tables.shape[1] - 1).long()]
    rows = torch.where(entry >= 0, entry, npool - 1).long()
    return rows, (idx % page).long()


# -------------------------------------------------------------------- prefill
def apply_block_prefill(p: Block, x, cfg: ModelConfig, kind: str,
                        attn_kind: str, *, positions=None, enc=None,
                        capacity: int = 0, memo=None):
    """Like ``apply_block`` but also returns a new decode cache holding the
    prompt's last ``min(S, n)`` keys in ring slots ``pos % n`` (a recurrent
    block: its state after the prompt; a cross-attention block: the K/V of
    ``enc`` in ``cfg.dtype``)."""
    if kind in (SSM, RGLRU):
        return _recurrent(p, x, cfg, kind, "prefill")
    if kind == CROSS:
        h = rmsnorm(p.norm1, x, cfg.norm_eps)
        y, (k, v) = attn_lib.cross_attention(p.attn, h, enc, cfg, memo=memo)
        cache = {"k": k.to(cfg.dtype).contiguous(),
                 "v": v.to(cfg.dtype).contiguous()}
        x, aux = _channel_mix(p, x, y, cfg)
        return x, cache, aux
    if kind != ATTN:
        raise ValueError(kind)
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    b, s, _ = x.shape
    y, (k, v) = attn_lib.self_attention(p.attn, h, cfg, attn_kind, positions,
                                        return_kv=True, memo=memo)
    cache = init_block_cache(cfg, kind, attn_kind, b, capacity, x.device)
    n = cache["k"].shape[1]
    take = min(s, n)
    src = torch.arange(s - take, s, dtype=torch.int32, device=x.device)
    slots = (src % n).long()
    cache["k"][:, slots] = k[:, s - take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - take:].to(cache["v"].dtype)
    cache["pos"][:, slots] = src
    x, aux = _channel_mix(p, x, y, cfg)
    return x, cache, aux


# ------------------------------------------------------------ chunked prefill
def apply_block_prefill_chunk(p: Block, x, cache, cfg: ModelConfig, kind: str,
                              attn_kind: str, *, start, memo=None):
    """Extend a decode cache with a prompt chunk x (B, C, d) at absolute
    positions [start, start + C).  The chunk's queries attend over
    ``[ring ‖ chunk]`` through the flash kernel, which takes the ring and
    its pos plane beside the chunk's own K/V and positions (nothing is
    concatenated), **before** the chunk's K/V is scattered into the ring,
    so a chunk that wraps the ring cannot overwrite keys its own queries
    still need.  The ring is updated in place.  A recurrent block threads
    its state through the chunk (``ssm_prefill_chunk`` /
    ``rglru_prefill_chunk``).  A cross-attention block refuses, as the
    reference's does: its cache is the encoder's, filled by whole-prompt
    prefill with ``enc``."""
    if kind in (SSM, RGLRU):
        return _recurrent(p, x, cfg, kind, "chunk", cache=cache)
    if kind != ATTN:
        raise NotImplementedError(
            f"chunked prefill is not supported for {kind!r} blocks "
            "(see model.chunked_prefill_caps)")
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    c = x.shape[1]
    n = cache["k"].shape[1]
    positions = attn_lib.shared(memo, "positions", lambda: torch.arange(
        int(start), int(start) + c, dtype=torch.int32, device=x.device))
    q, k, v = attn_lib._project_qkv(p.attn, h, cfg, positions, attn_kind,
                                    memo)
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    out = ops.flash_attention(
        q, k, v, q_pos=positions, k_pos=positions, causal=True,
        window=attn_lib._window_for(cfg, attn_kind),
        scale=attn_lib._scale(cfg), softcap=cfg.logit_softcap,
        k_cache=cache["k"], v_cache=cache["v"], cache_pos=cache["pos"])
    # now scatter the chunk's last min(C, n) keys into the ring (older ones
    # are already beyond the ring and can never be read)
    take = min(c, n)
    src = positions[c - take:]
    slots = (src % n).long()
    cache["k"][:, slots] = k[:, c - take:]
    cache["v"][:, slots] = v[:, c - take:]
    cache["pos"][:, slots] = src
    x, aux = _channel_mix(p, x, attn_lib._out_proj(out, p.attn["wo"]), cfg)
    return x, cache, aux

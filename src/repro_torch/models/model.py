"""Decoder-only LM over the block stack.

``Model`` is an ``nn.Module`` holding per-layer ``Block``s in a plain list
(no scan over pattern periods); caches are a list of per-layer dicts with
the JAX per-layer layout (attention: ``k``/``v`` (B, n, Hkv, D), ``pos``
(B, n) int32, -1 = empty; SSD: ``conv``/``state``; RG-LRU: ``conv``/``h``;
cross-attention: the encoder's ``k``/``v`` (B, T, Hkv, D)).
The functions keep the JAX package's names and signatures:
``forward``, ``init_cache``, ``init_paged_cache``, ``prefill``,
``prefill_chunk``, ``decode_step``, ``paged_commit``, ``paged_restore``,
``paged_copy_page`` and ``chunked_prefill_caps``.  The functions that take a
cache update it **in place** and return it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ATTN, CROSS, ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import layers as lyr
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rope as rope_lib

Cache = List[Dict[str, torch.Tensor]]


class Model(nn.Module):
    """Parameters of one decoder-only LM: embedding table, per-layer
    blocks, final norm and (untied configs) the output head."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dev = torch.device(device)
        self.embed = blk._param((cfg.vocab_size, cfg.d_model), cfg.dtype, dev)
        self.layers = nn.ModuleList(
            blk.Block(cfg, kind, akind, dev)
            for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds()))
        self.final_norm = blk._param((cfg.d_model,), torch.float32, dev, 0.0)
        self.head = (None if cfg.tie_embeddings else
                     blk._param((cfg.d_model, cfg.vocab_size), cfg.dtype, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ------------------------------------------------------------------------ init
def _init_ssm_(p, gen: torch.Generator) -> None:
    """The reference's Mamba2 initializers: fan-in projections and conv
    taps, zero conv bias and norm gain, ``dt_bias`` the inverse softplus of
    a log-uniform dt in [0.001, 0.1], ``a_log`` the log of U(1, 16) and a
    unit skip."""
    for name in ("in_proj", "conv_w", "out_proj"):
        lyr.dense_init_(p[name], 0, gen)
    p["conv_b"].zero_()
    p["norm"].zero_()
    p["d_skip"].fill_(1.0)
    u = torch.rand(p["dt_bias"].shape, generator=gen, device=gen.device)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    u = torch.rand(p["a_log"].shape, generator=gen, device=gen.device)
    p["a_log"].copy_(torch.log(1.0 + 15.0 * u))


def _init_rglru_(p, cfg: ModelConfig, gen: torch.Generator) -> None:
    """The reference's Griffin initializers: fan-in projections and conv
    taps, zero biases, and the linspace(0.9, 0.999) Lambda."""
    for name in ("w_x", "w_y", "conv_w", "w_a", "w_i", "w_out"):
        lyr.dense_init_(p[name], 0, gen)
    for name in ("conv_b", "b_a", "b_i"):
        p[name].zero_()
    p["lam"].copy_(rglru_lib.lam_init(cfg, p["lam"].device))


def init_moe_(p, gen: torch.Generator) -> None:
    """The reference's MoE initializers: the router with fan-in on axis 0
    and the (E, d, f) / (E, f, d) expert tensors with fan-in on axis 1
    (std 1/sqrt(d) for ``w_gate``/``w_up``, 1/sqrt(f) for ``w_down``),
    drawn expert by expert so that the float32 draw holds one expert's
    slice, never the whole tensor; arctic's dense MLP as a dense one."""
    lyr.dense_init_(p["router"], 0, gen)
    for name in ("w_gate", "w_up", "w_down"):
        for w in p[name]:
            lyr.dense_init_(w, 0, gen)
    if p.dense is not None:
        for name in p.dense:
            lyr.dense_init_(p.dense[name], 0, gen)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``seed``, drawn on ``device`` with a
    ``torch.Generator``: truncated-normal fan-in projections, a standard
    normal embedding, zero norm gains and the recurrent mixers' own
    initializers (the reference's distributions; the draws themselves
    differ from JAX's).  Each tensor is drawn into a float32 temporary of
    its own shape (an MoE expert tensor: one expert's slice at a time)."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for layer in model.layers:
        if layer.ssm is not None:
            _init_ssm_(layer.ssm, gen)
        elif layer.rec is not None:
            _init_rglru_(layer.rec, cfg, gen)
        else:
            # fan-in is read from axis 0 for every projection, wo's
            # (H, hd, d) included, exactly as the reference's dense_init does
            for name in ("wq", "wk", "wv", "wo"):
                lyr.dense_init_(layer.attn[name], 0, gen)
        if layer.mlp is not None:
            for name in layer.mlp:
                lyr.dense_init_(layer.mlp[name], 0, gen)
        if layer.moe is not None:
            init_moe_(layer.moe, gen)
    lyr.embed_init_(model.embed, gen)
    if model.head is not None:
        lyr.dense_init_(model.head, 0, gen)
    return model


def count_params(cfg: ModelConfig) -> int:
    """Parameter count (embedding once if tied), from shapes alone."""
    return sum(p.numel() for p in Model(cfg, "meta").parameters())


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top-k experts count)."""
    total = count_params(cfg)
    if not cfg.num_experts:
        return total
    expert_p = 3 * cfg.d_model * cfg.d_ff          # gate/up/down per expert
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k in (ATTN, CROSS))
    inactive = n_moe_layers * (cfg.num_experts - cfg.num_experts_per_tok) * expert_p
    return total - inactive


# --------------------------------------------------------------------- forward
def _embed(params: Model, tokens, cfg: ModelConfig):
    if tokens.dim() == 2:
        return lyr.embed(params.embed, tokens, cfg)
    return tokens.to(cfg.dtype)


def _logits(params: Model, x, cfg: ModelConfig):
    x = lyr.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return lyr.logits_head(params.embed, x, cfg, params.head)


def _need_enc(cfg: ModelConfig, enc) -> None:
    """A stack with a cross-attention layer attends over encoder states:
    refuse to run it without them."""
    if enc is None and CROSS in cfg.layer_kinds():
        raise ValueError(
            f"{cfg.name} has cross-attention layers: pass the encoder "
            f"states enc (B, {cfg.num_image_tokens}, {cfg.d_model})")


def _rope_memo(cfg: ModelConfig, positions) -> dict:
    """A call's memo with every attention layer's rope table built: under
    remat each layer is recomputed, and a table first built inside a
    checkpointed layer would be another tensor in its recompute."""
    memo = {}
    for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds()):
        if kind == ATTN:
            theta = attn_lib._rope_theta_for(cfg, akind)
            attn_lib.shared(memo, ("rope", theta), lambda: rope_lib.rope_freqs(
                cfg.resolved_head_dim, theta, positions))
    return memo


def forward(params: Model, tokens, cfg: ModelConfig, *, enc=None,
            num_groups: int = 1, training: bool = False,
            apply=blk.apply_block) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int (or (B, S, d_model) embeddings).  ``enc`` (B, T,
    d_model): the encoder states a cross-attention layer attends over.
    ``num_groups``: the MoE FFN's capacity groups.  With ``training`` and
    ``cfg.remat`` every layer is checkpointed (its activations recomputed
    in the backward), as the reference checkpoints each period; the final
    norm and the head stay outside.  ``apply`` runs one layer
    (``apply_block``'s signature; the sharded trainer's gathers its
    parameters first, ``sharding.placement``).  Returns (logits (B, S, V),
    aux loss scalar)."""
    _need_enc(cfg, enc)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    memo = _rope_memo(cfg, positions)
    for layer in params.layers:
        kw = dict(positions=positions, enc=enc, memo=memo,
                  num_groups=num_groups)
        args = (layer, x, cfg, layer.kind, layer.attn_kind)
        if training and cfg.remat:
            x, a = checkpoint(apply, *args, use_reentrant=False, **kw)
        else:
            x, a = apply(*args, **kw)
        aux = aux + a
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> Cache:
    dev = resolve_device(device)
    return [blk.init_block_cache(cfg, kind, akind, batch, capacity, dev)
            for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds())]


def ring_lengths(cfg: ModelConfig, capacity: int) -> set:
    """The slot counts of the attention layers' rings at ``capacity`` (a
    local layer's ring holds its window)."""
    return {blk._attn_cache_len(cfg, akind, capacity)
            for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds())
            if kind == ATTN}


def init_paged_cache(cfg: ModelConfig, batch: int, capacity: int,
                     num_pages: int, page_size: int, device="cuda") -> Cache:
    """Like ``init_cache`` but every attention layer's KV lives in a shared
    page pool indexed through per-lane block tables: ``{"k"/"v":
    (num_pages + 1, page_size, Hkv, D), "pos": (num_pages + 1, page_size)}``
    (pos -1 = empty).  The extra last row is the write dump for lanes with
    no page mapped.  ``batch`` and ``capacity`` size the other layer kinds:
    a recurrent layer keeps its per-lane state and a cross-attention layer
    its per-lane encoder K/V, lane-leading as in ``init_cache``."""
    dev = resolve_device(device)
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    cache: Cache = []
    for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds()):
        if kind != ATTN:
            cache.append(blk.init_block_cache(cfg, kind, akind, batch,
                                              capacity, dev))
            continue
        shape = (num_pages + 1, page_size, hkv, hd)
        cache.append({
            "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.full(shape[:2], -1, dtype=torch.int32, device=dev),
        })
    return cache


# ---------------------------------------------------------------------- decode
def decode_step(params: Model, cache: Cache, tokens, cache_index,
                cfg: ModelConfig, *, block_tables=None
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, 1) int.  One decode step: every lane writes its KV at its
    own ``cache_index`` (an int or a (B,) tensor) and gets the next token's
    logits (B, 1, V).  ``cache`` is updated in place and returned.

    ``block_tables`` ((B, max_pages) int, -1 = absent) switches attention
    layers to the paged pools of ``init_paged_cache``; the same table
    indexes every layer's pool."""
    x = _embed(params, tokens, cfg)
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
    if idx.dim() == 0:
        idx = idx.expand(x.shape[0]).contiguous()
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                       device=x.device).contiguous()
    memo = {}
    for layer, c in zip(params.layers, cache):
        x, _, _ = blk.apply_block_decode(layer, x, c, cfg, layer.kind,
                                         layer.attn_kind, cache_index=idx,
                                         block_tables=block_tables, memo=memo)
    return _logits(params, x, cfg), cache


# ----------------------------------------------------------- paged lane moves
def paged_commit(cache: Cache, lane_cache: Cache, lane: int, table_row,
                 from_pos: int, cfg: ModelConfig, page_size: int) -> Cache:
    """Install a finished lane prefill into the paged cache, in place.

    ``lane_cache`` is the private B=1 ring cache chunked prefill filled
    (``init_cache(cfg, 1, capacity)``): its entry at absolute position
    ``p`` lands in pool row ``table_row[p // page_size]``, slot
    ``p % page_size``.  Entries with ``p < from_pos``, and entries whose
    table entry is -1, go to the dump row instead: positions below
    ``from_pos`` live in shared prefix pages other lanes (or the prefix
    cache) may be reading, and a commit never writes a page the lane does
    not own.  A recurrent layer's leaves are copied into batch row ``lane``,
    as ``Replica._insert`` does in ring mode."""
    maxp = table_row.shape[0]
    for kind, layer, ring in zip(cfg.layer_kinds(), cache, lane_cache):
        if kind != ATTN:
            for name, t in layer.items():
                t[int(lane)].copy_(ring[name][0])
            continue
        dump = layer["k"].shape[0] - 1
        p = ring["pos"][0]                                 # (n,) positions
        valid = (p >= 0) & (p >= int(from_pos))
        pp = p.clamp_min(0)
        slot = (pp // page_size).clamp_max(maxp - 1).long()
        rows = torch.where(valid, table_row[slot], dump)
        rows = torch.where(rows >= 0, rows, dump).long()
        within = (pp % page_size).long()
        layer["k"][rows, within] = ring["k"][0].to(layer["k"].dtype)
        layer["v"][rows, within] = ring["v"][0].to(layer["v"].dtype)
        layer["pos"][rows, within] = p
    return cache


def paged_restore(cache: Cache, lane_cache: Cache, table_row, matched: int,
                  cfg: ModelConfig, page_size: int) -> Cache:
    """Fill a fresh B=1 prefill ring from cached prefix pages, in place.

    The inverse of ``paged_commit``: ring slot ``s`` receives the pool entry
    for the absolute position the ring would hold after prefilling
    ``matched`` tokens, ``p = s + ((matched - 1 - s) // n) * n``, while
    ``0 <= p < matched``; other slots keep their K/V and get pos -1.  Chunk
    prefill then continues from ``start = matched``.  Recurrent layers are
    left untouched: their state cannot be rebuilt from KV pages (the engine
    refuses prefix reuse on such stacks)."""
    maxp = table_row.shape[0]
    for kind, layer, ring in zip(cfg.layer_kinds(), cache, lane_cache):
        if kind != ATTN:
            continue
        n = ring["k"].shape[1]
        s = torch.arange(n, dtype=torch.int64, device=ring["k"].device)
        p = s + ((int(matched) - 1 - s) // n) * n
        valid = (p >= 0) & (p < int(matched))
        sp = torch.where(valid, p, 0)
        rows = table_row[(sp // page_size).clamp_max(maxp - 1)]
        rows = torch.where(valid & (rows >= 0), rows,
                           layer["k"].shape[0] - 1).long()
        within = sp % page_size
        keep = valid[:, None, None]
        ring["k"][0] = torch.where(keep, layer["k"][rows, within]
                                   .to(ring["k"].dtype), ring["k"][0])
        ring["v"][0] = torch.where(keep, layer["v"][rows, within]
                                   .to(ring["v"].dtype), ring["v"][0])
        ring["pos"][0] = torch.where(valid, p, -1).to(torch.int32)
    return lane_cache


def paged_copy_page(cache: Cache, src: int, dst: int,
                    cfg: ModelConfig) -> Cache:
    """Copy pool row ``src`` to ``dst`` (K, V and pos) in every attention
    layer, in place: the device half of copy-on-write.  Recurrent layers,
    whose leading axis is the lane and not a page, are left alone."""
    for kind, layer in zip(cfg.layer_kinds(), cache):
        if kind != ATTN:
            continue
        for t in layer.values():
            t[int(dst)].copy_(t[int(src)])
    return cache


# ------------------------------------------------------------ chunked prefill
def chunked_prefill_caps(cfg: ModelConfig, capacity: int) -> Dict[str, Any]:
    """Per-kind chunked-prefill capability report (see the JAX package's
    ``chunked_prefill_caps``): ``kinds`` per layer-kind label,
    ``supported``, ``max_chunk_tokens`` (the smallest attention ring) and
    ``max_prompt_tokens`` (None for unbounded)."""
    kinds: Dict[str, bool] = {}
    max_chunk = capacity
    max_prompt: Optional[int] = None
    for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds()):
        if kind == ATTN:
            kinds[f"attn:{akind}"] = True
            n = blk._attn_cache_len(cfg, akind, capacity)
            max_chunk = min(max_chunk, n)
            window = attn_lib._window_for(cfg, akind)
            if window == 0 or n < window:
                max_prompt = n if max_prompt is None else min(max_prompt, n)
        elif kind == CROSS:
            kinds["cross"] = False
        else:
            kinds[kind] = True
    return {
        "kinds": kinds,
        "supported": all(kinds.values()) if kinds else False,
        "max_chunk_tokens": max(int(max_chunk), 1),
        "max_prompt_tokens": max_prompt,
    }


def prefill_chunk(params: Model, cache: Cache, tokens, start: int,
                  cfg: ModelConfig, *, return_all_logits: bool = False
                  ) -> Tuple[torch.Tensor, Cache]:
    """Extend ``cache`` with prompt chunk ``tokens`` ((B, C) int) whose first
    token sits at absolute position ``start``.  Returns the last position's
    logits (B, 1, V), or all C with ``return_all_logits``, and the cache,
    updated in place.  Start from a fresh ``init_cache`` with ``start=0``."""
    x = _embed(params, tokens, cfg)
    memo = {}
    for layer, c in zip(params.layers, cache):
        x, _, _ = blk.apply_block_prefill_chunk(layer, x, c, cfg, layer.kind,
                                                layer.attn_kind, start=start,
                                                memo=memo)
    sel = x if return_all_logits else x[:, -1:]
    return _logits(params, sel, cfg), cache


# --------------------------------------------------------------------- prefill
def prefill(params: Model, tokens, cfg: ModelConfig, capacity: int, *,
            enc=None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt through the stack: last-position logits (B, 1, V) and
    a new cache filled up to ``tokens.shape[1]`` (ready for decode at index
    S, S+1, ...).  A cross-attention layer's cache holds the K/V of
    ``enc`` (B, T, d_model), which such a stack requires."""
    _need_enc(cfg, enc)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cache: Cache = []
    memo = {}
    for layer in params.layers:
        x, c, _ = blk.apply_block_prefill(layer, x, cfg, layer.kind,
                                          layer.attn_kind,
                                          positions=positions, enc=enc,
                                          capacity=capacity, memo=memo)
        cache.append(c)
    return _logits(params, x[:, -1:], cfg), cache

"""Decoder-only LM over the block stack.

``Model`` is an ``nn.Module`` holding per-layer ``Block``s in a plain list
(no scan over pattern periods); caches are a list of per-layer dicts with
the JAX per-layer layout (``k``/``v`` (B, n, Hkv, D), ``pos`` (B, n) int32,
-1 = empty).  The functions keep the JAX package's names and signatures:
``forward``, ``init_cache``, ``prefill``, ``prefill_chunk``,
``decode_step`` and ``chunked_prefill_caps``.  ``prefill_chunk`` and
``decode_step`` update the cache they are given **in place** and return it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.config import ATTN, CROSS, ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import layers as lyr

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
def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``seed``, drawn on ``device`` with a
    ``torch.Generator``: truncated-normal fan-in projections, a standard
    normal embedding, zero norm gains (the reference's initializers; the
    draws themselves differ from JAX's)."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for layer in model.layers:
        # fan-in is read from axis 0 for every projection, wo's (H, hd, d)
        # included, exactly as the reference's dense_init does
        for name in ("wq", "wk", "wv", "wo"):
            lyr.dense_init_(layer.attn[name], 0, gen)
        if layer.mlp is not None:
            for name in layer.mlp:
                lyr.dense_init_(layer.mlp[name], 0, gen)
    lyr.embed_init_(model.embed, gen)
    if model.head is not None:
        lyr.dense_init_(model.head, 0, gen)
    return model


def count_params(cfg: ModelConfig) -> int:
    """Parameter count (embedding once if tied), from shapes alone."""
    return sum(p.numel() for p in Model(cfg, "meta").parameters())


# --------------------------------------------------------------------- forward
def _embed(params: Model, tokens, cfg: ModelConfig):
    if tokens.dim() == 2:
        return lyr.embed(params.embed, tokens, cfg)
    return tokens.to(cfg.dtype)


def _logits(params: Model, x, cfg: ModelConfig):
    x = lyr.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return lyr.logits_head(params.embed, x, cfg, params.head)


def forward(params: Model, tokens, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int.  Returns (logits (B, S, V), aux loss scalar)."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    memo = {}
    for layer in params.layers:
        x, a = blk.apply_block(layer, x, cfg, layer.kind, layer.attn_kind,
                               positions=positions, memo=memo)
        aux = aux + a
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> Cache:
    dev = resolve_device(device)
    return [blk.init_block_cache(cfg, kind, akind, batch, capacity, dev)
            for kind, akind in zip(cfg.layer_kinds(), cfg.attn_kinds())]


# ---------------------------------------------------------------------- decode
def decode_step(params: Model, cache: Cache, tokens, cache_index,
                cfg: ModelConfig, *, block_tables=None
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, 1) int.  One decode step: every lane writes its KV at its
    own ``cache_index`` (an int or a (B,) tensor) and gets the next token's
    logits (B, 1, V).  ``cache`` is updated in place and returned."""
    x = _embed(params, tokens, cfg)
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
    if idx.dim() == 0:
        idx = idx.expand(x.shape[0]).contiguous()
    memo = {}
    for layer, c in zip(params.layers, cache):
        x, _, _ = blk.apply_block_decode(layer, x, c, cfg, layer.kind,
                                         layer.attn_kind, cache_index=idx,
                                         block_tables=block_tables, memo=memo)
    return _logits(params, x, cfg), cache


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
def prefill(params: Model, tokens, cfg: ModelConfig, capacity: int
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt through the stack: last-position logits (B, 1, V) and
    a new cache filled up to ``tokens.shape[1]`` (ready for decode at index
    S, S+1, ...)."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cache: Cache = []
    memo = {}
    for layer in params.layers:
        x, c, _ = blk.apply_block_prefill(layer, x, cfg, layer.kind,
                                          layer.attn_kind,
                                          positions=positions,
                                          capacity=capacity, memo=memo)
        cache.append(c)
    return _logits(params, x[:, -1:], cfg), cache

"""Plain PyTorch attention oracles (the port of ``repro.kernels.ref``).

Each function keeps the numerics of its JAX twin:

* ``mha_reference`` / ``mha_cache_masked`` upcast q, k and v to float32 and
  run the whole softmax in float32;
* ``decode_mha_reference`` does the same for one query per lane;
* ``decode_mha_masked`` keeps the cache in its storage dtype, accumulates
  the logits in float32, and casts the probabilities to ``v.dtype`` before
  P·V (float32 accumulation again);
* ``paged_decode_mha_reference`` gathers each lane's pages through its
  block table and defers to ``decode_mha_masked``.

These are the CPU path of the port and the oracles its Hopper kernels are
held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, T, Hkv, D) -> (B, T, Hq, D) by repeating kv heads."""
    rep = num_q_heads // k.shape[2]
    return k if rep == 1 else k.repeat_interleave(rep, dim=2)


def _attn_mask(q_len: int, kv_len: int, causal: bool, window: int,
               q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask.  True = attend."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def _softmax_attend(q, k, v, mask, scale, softcap):
    """f32 softmax attention of q (B,S,Hq,D) over k/v (B,T,Hq,D) under a
    mask broadcastable to (B, Hq, S, T)."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v.float())


def mha_reference(q, k, v, *, causal=True, window=0, scale=None, softcap=0.0,
                  q_offset=0):
    """q: (B,S,Hq,D); k,v: (B,T,Hkv,D) -> (B,S,Hq,D).  Full softmax oracle."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    mask = _attn_mask(s, t, causal, window, q_offset, q.device)
    out = _softmax_attend(q, _gqa_expand(k, hq), _gqa_expand(v, hq),
                          mask[None, None], scale, softcap)
    return out.to(q.dtype)


def decode_mha_reference(q, k_cache, v_cache, *, cache_len, window=0,
                         scale=None, softcap=0.0):
    """q: (B,1,Hq,D); caches: (B,Smax,Hkv,D).  Mask = [cache_len-window,
    cache_len); ``cache_len`` is an int or a per-lane ``(B,)`` tensor."""
    b, _, hq, d = q.shape
    smax = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    j = torch.arange(smax, device=q.device)
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=q.device).reshape(-1, 1)     # (1|B, 1)
    m = j[None, :] < cl
    if window > 0:
        m &= j[None, :] > cl - 1 - window
    out = _softmax_attend(q, _gqa_expand(k_cache, hq), _gqa_expand(v_cache, hq),
                          m[:, None, None, :], scale, softcap)
    return out.to(q.dtype)


def decode_mha_masked(q, k_cache, v_cache, *, valid_mask, scale=None,
                      softcap=0.0):
    """Decode attention over a ring cache: attend to slots where
    ``valid_mask`` ((Smax,) or per-lane (B, Smax) bool) is set.  The cache
    is consumed in its storage dtype with float32 accumulation, and the
    probabilities are cast to ``v.dtype`` before P·V."""
    b, _, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, hq)
    v = _gqa_expand(v_cache, hq)
    # f32 accumulation of storage-dtype products: upcasting the operands is
    # exact for bf16 inputs (every bf16 product is exact in f32)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    vm = valid_mask[None] if valid_mask.dim() == 1 else valid_mask
    logits = torch.where(vm[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def paged_decode_mha_reference(q, k_pages, v_pages, pos_pages, tables, *,
                               cache_len, window=0, scale=None, softcap=0.0):
    """Block-table decode oracle: gather each lane's pages, then attend.

    q: (B, 1, Hq, D); k/v_pages: (P, page, Hkv, D) pools (P includes the
    dump row); pos_pages: (P, page) int32 position written at each slot
    (-1 empty); tables: (B, maxp) int32, entry j the page backing positions
    [j*page, (j+1)*page) or -1; cache_len: int or (B,).  A gathered slot is
    visible when its table entry exists, its written position equals the
    slot's expected absolute position, that position is below cache_len,
    and it is inside the window; the math is ``decode_mha_masked``'s."""
    b = q.shape[0]
    page = k_pages.shape[1]
    maxp = tables.shape[1]
    safe = tables.clamp_min(0).long()                           # (B, maxp)
    k = k_pages[safe].reshape(b, maxp * page, *k_pages.shape[2:])
    v = v_pages[safe].reshape(b, maxp * page, *v_pages.shape[2:])
    pos = pos_pages[safe].reshape(b, maxp * page)               # (B, T)
    expected = torch.arange(maxp * page, dtype=torch.int32,
                            device=q.device)[None]              # (1, T)
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b).reshape(b, 1)
    valid = (pos == expected) & (expected < cl)
    valid &= (tables >= 0).repeat_interleave(page, dim=1)
    if window > 0:
        valid &= expected > cl - 1 - window
    return decode_mha_masked(q, k, v, valid_mask=valid, scale=scale,
                             softcap=softcap)


def mha_cache_masked(q, k_cache, v_cache, *, mask, scale=None, softcap=0.0):
    """Multi-query attention against a (partially filled) KV cache with an
    explicit per-query mask: the chunked-prefill oracle.

    q: (B,C,Hq,D) chunk queries; caches: (B,T,Hkv,D); mask: (B,C,T) bool
    (True = attend).  f32 math throughout, like ``mha_reference``."""
    b, c, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = _softmax_attend(q, _gqa_expand(k_cache, hq), _gqa_expand(v_cache, hq),
                          mask[:, None], scale, softcap)
    return out.to(q.dtype)

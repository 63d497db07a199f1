"""Plain PyTorch oracles (the port of ``repro.kernels.ref``).

Each function keeps the numerics of its JAX twin:

* ``mha_reference`` / ``mha_cache_masked`` upcast q, k and v to float32 and
  run the whole softmax in float32;
* ``decode_mha_reference`` does the same for one query per lane;
* ``decode_mha_masked`` keeps the cache in its storage dtype, accumulates
  the logits in float32, and casts the probabilities to ``v.dtype`` before
  P·V (float32 accumulation again);
* ``paged_decode_mha_reference`` gathers each lane's pages through its
  block table and defers to ``decode_mha_masked``;
* the SSD (``ssd_reference``, ``ssd_chunked``, ``ssd_decode_step``) and
  RG-LRU (``rglru_reference``, ``rglru_chunked``, ``rglru_decode_step``)
  scans and the causal depthwise conv run in float32 and round once to
  the input dtype; ``rglru_chunked`` combines in the order of
  ``jax.lax.associative_scan``;
* ``moe_ffn_reference`` is the MoE FFN as a plain loop over tokens and
  their choices (no JAX twin: it checks ``models.moe.moe_ffn``, which
  follows ``repro.models.moe``).

These are the CPU path of the port and the oracles its Hopper kernels are
held against.
"""
from __future__ import annotations

import math

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
    k, v, valid = paged_gather(k_pages, v_pages, pos_pages, tables,
                               cache_len, window)
    return decode_mha_masked(q, k, v, valid_mask=valid, scale=scale,
                             softcap=softcap)


def paged_gather(k_pages, v_pages, pos_pages, tables, cache_len, window=0):
    """Each lane's pages gathered in position order, as the paged oracle
    reads them: (k, v) (B, maxp * page, Hkv, D) and the visibility mask
    (B, maxp * page) of ``paged_decode_mha_reference``."""
    b, maxp = tables.shape
    page = k_pages.shape[1]
    safe = tables.clamp_min(0).long()                           # (B, maxp)
    k = k_pages[safe].reshape(b, maxp * page, *k_pages.shape[2:])
    v = v_pages[safe].reshape(b, maxp * page, *v_pages.shape[2:])
    pos = pos_pages[safe].reshape(b, maxp * page)               # (B, T)
    expected = torch.arange(maxp * page, dtype=torch.int32,
                            device=k.device)[None]              # (1, T)
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=k.device).reshape(-1).expand(b).reshape(b, 1)
    valid = (pos == expected) & (expected < cl)
    valid &= (tables >= 0).repeat_interleave(page, dim=1)
    if window > 0:
        valid &= expected > cl - 1 - window
    return k, v, valid


def local_attend(q, k, v, valid, scale, softcap=0.0):
    """One query token a lane over the slots ``valid`` ((B, T) bool) marks,
    as a partial softmax state: (m, l, acc) of shapes (B, Hq), (B, Hq) and
    (B, Hq, D), f32, with m the largest logit (natural-log units; NEG_INF
    where nothing is visible), l the sum of exp(logit - m) and acc the
    exp(logit - m)-weighted sum of V rows, probabilities rounded to V's
    dtype first.  The counterpart of the reference's spmd ``_local_attend``;
    ``combine_partials`` joins such states."""
    hq = q.shape[2]
    logits = torch.einsum("bhd,bthd->bht", q[:, 0].float(),
                          _gqa_expand(k, hq).float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    vm = valid[:, None, :]
    logits = torch.where(vm, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                                     # (B, Hq)
    p = torch.where(vm, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bht,bthd->bhd", p.to(v.dtype).float(),
                       _gqa_expand(v, hq).float())
    return m, p.sum(dim=-1), acc


def combine_partials(ml, part, dtype):
    """Join partial softmax states by their log-sum-exp: ``ml`` (R, S, 2)
    holds each state's (m, l), ``part`` (R, S, D) its acc.  Returns (R, D)
    in ``dtype``: the reference's ``pmax``/``psum`` combine.  A row whose
    states are all empty (m NEG_INF, l 0) comes out as zeros."""
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp(m - m.amax(dim=1, keepdim=True))              # (R, S)
    total = (l * w).sum(dim=1)
    acc = (part * w[..., None]).sum(dim=1)
    return (acc / total.clamp_min(1e-30)[:, None]).to(dtype)


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


# ===================================================================== SSD
def segsum(log_a):
    """(..., S) -> (..., S, S) lower-triangular cumulative log-decay:
    out[i, j] = sum_{r=j+1..i} log_a[r]  (i >= j), -inf above the
    diagonal."""
    s = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def ssd_reference(x, dt, a_log, b_mat, c_mat, d_skip=None):
    """Mamba2 SSD oracle (quadratic: small shapes only).

    x (B,S,H,P) per-head inputs; dt (B,S,H) post-softplus timestep; a_log
    (H,), A = -exp(a_log); b_mat/c_mat (B,S,N) (one group, broadcast to the
    heads); d_skip (H,) or None.  Returns (B,S,H,P) in x's dtype."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    log_decay = dt.to(f32) * a[None, None, :]                   # (B,S,H)
    ls = segsum(log_decay.transpose(1, 2))                      # (B,H,S,S)
    cb = torch.einsum("bsn,btn->bst", c_mat.to(f32), b_mat.to(f32))
    att = cb[:, None] * torch.exp(ls)
    xb = x.to(f32) * dt.to(f32)[..., None]
    y = torch.einsum("bhst,bthp->bshp", att, xb)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip=None, chunk=128):
    """Linear-time chunked SSD (state-space duality), the TPU kernel's
    algorithm: the quadratic term inside each chunk plus the inter-chunk
    state recurrence, all in float32."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd: seq {s} % chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    log_decay = (dt.to(f32) * a[None, None, :]).reshape(bsz, nc, chunk, h)
    xb = (x.to(f32) * dt.to(f32)[..., None]).reshape(bsz, nc, chunk, h, p)
    bm = b_mat.to(f32).reshape(bsz, nc, chunk, n)
    cm = c_mat.to(f32).reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(log_decay, dim=2)                        # (B,NC,Q,H)
    total = cum[:, :, -1]                                       # (B,NC,H)
    # intra-chunk (quadratic within the chunk)
    ls = segsum(log_decay.permute(0, 1, 3, 2))                  # (B,NC,H,Q,Q)
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    att = cb[:, :, None] * torch.exp(ls)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, xb)
    # chunk states: S_c = sum_j exp(total - cum_j) B_j (x dt)_j
    decay_to_end = torch.exp(total[:, :, None] - cum)           # (B,NC,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bm, decay_to_end, xb)
    # inter-chunk recurrence: the state before each chunk
    hs = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(hs)
        hs = torch.exp(total[:, c])[..., None, None] * hs + states[:, c]
    h_before = torch.stack(before, dim=1)                       # (B,NC,H,N,P)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cm, torch.exp(cum),
                           h_before)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype)


def ssd_decode_step(h_state, x_t, dt_t, a_log, b_t, c_t, d_skip=None):
    """One-token SSD step.  h_state (B,H,N,P) f32; x_t (B,H,P); dt_t (B,H);
    b_t/c_t (B,N).  Returns (y_t (B,H,P) in x_t's dtype, h_new f32)."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    decay = torch.exp(dt_t.to(f32) * a[None, :])                # (B,H)
    xb = x_t.to(f32) * dt_t.to(f32)[..., None]                  # (B,H,P)
    h_new = decay[..., None, None] * h_state + torch.einsum(
        "bn,bhp->bhnp", b_t.to(f32), xb)
    y = torch.einsum("bn,bhnp->bhp", c_t.to(f32), h_new)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, :, None] * x_t.to(f32)
    return y.to(x_t.dtype), h_new


# ================================================================== RG-LRU
def _rglru_terms(x, log_a, gate_x):
    """a = exp(log_a) and b = sqrt(max(1 - a^2, 0)) * gate * x, float32."""
    f32 = torch.float32
    la = log_a.to(f32)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * la), 0.0))
    return torch.exp(la), beta * gate_x.to(f32) * x.to(f32)


def rglru_reference(x, log_a, gate_x):
    """RG-LRU oracle as a step loop over time: h_t = a_t h_{t-1} +
    sqrt(1 - a_t^2) (gate_t x_t) from h_0 = 0.  x, log_a (<= 0) and
    gate_x (already sigmoided): (B,S,D).  Returns (B,S,D) in x's dtype."""
    a, bx = _rglru_terms(x, log_a, gate_x)
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


def _interleave(even, odd, dim: int):
    """Elements of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ...
    along ``dim``."""
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def _associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim``, combining in the
    order ``jax.lax.associative_scan`` does (pairs, recurse, fill the
    evens), so float32 results round as the reference's do."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = combine([sl(e, 0, -1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = _associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def rglru_chunked(x, log_a, gate_x):
    """Associative-scan RG-LRU (log depth, linear memory): the reference's
    production path.  Same arguments and result as ``rglru_reference``."""
    a, bx = _rglru_terms(x, log_a, gate_x)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return [a1 * a2, b1 * a2 + b2]

    _, b_s = _associative_scan(combine, [a, bx], dim=1)
    return b_s.to(x.dtype)


def rglru_decode_step(h_state, x_t, log_a_t, gate_x_t):
    """h_state (B,D) f32; x_t/log_a_t/gate_x_t (B,D).  Returns (y in x_t's
    dtype, h_new f32)."""
    a, bx = _rglru_terms(x_t, log_a_t, gate_x_t)
    h_new = a * h_state + bx
    return h_new.to(x_t.dtype), h_new


# ============================================================ causal conv1d
def causal_conv1d(x, w, b=None):
    """Depthwise causal conv: x (B,S,D), w (W,D), b (D,) or None.  float32
    taps, result in x's dtype."""
    width = w.shape[0]
    s = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype)


def causal_conv1d_step(conv_state, x_t, w, b=None):
    """One conv step: conv_state (B,W-1,D) past inputs, x_t (B,D).  Returns
    (out (B,D) in x_t's dtype, the new state (B,W-1,D))."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)
    out = torch.einsum("bwd,wd->bd", window.to(torch.float32),
                       w.to(torch.float32))
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x_t.dtype), window[:, 1:]


# ===================================================================== MoE
def _swiglu(x, w_gate, w_up, w_down):
    """SiLU-gated FFN in x's dtype, with the reference's rounding of the
    SiLU: a = x @ w_gate, then 1 + exp(-a), its reciprocal, a times that
    and times x @ w_up, each rounded to x's dtype."""
    a = x @ w_gate
    return (a * (1.0 / (1.0 + torch.exp(-a))) * (x @ w_up)) @ w_down


def moe_ffn_reference(p, x, cfg, num_groups: int = 1):
    """The MoE FFN token by token: a plain loop, independent of the
    gather formulation of ``models.moe.moe_ffn``.  x: (B, S, D).

    The router logits are one product ``x @ router`` in x's dtype, the
    probabilities a float32 softmax.  Then, group by group and token by
    token in order, each token takes its k most probable experts (ties to
    the lower index), with weights renormalized over the k; a (token,
    choice) is kept while its expert has served fewer than the capacity
    ``min(max(4, ceil(k * Tg * factor / E) rounded up to a multiple of
    4), Tg * k)`` in this group, and a kept one adds ``weight * FFN_e(x_t)``
    (SwiGLU in x's dtype, ``_swiglu``, the weight rounded to it) to its
    token's row.
    Arctic's dense SwiGLU FFN (``moe_dense_ff``) is added on every row.
    Returns (y (B, S, D), kept: the kept (token, choice) pairs in order)."""
    bsz, s, d = x.shape
    t = bsz * s
    g = num_groups if t % num_groups == 0 else 1
    tg = t // g
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    want = math.ceil(k * tg * cfg.moe_capacity_factor / e)
    cap = min(max(4, -(-want // 4) * 4), tg * k)
    x2 = x.reshape(t, d)
    probs = torch.softmax((x2 @ p["router"]).float(), dim=-1).cpu()
    out = torch.zeros_like(x2)
    kept = []
    for g0 in range(0, t, tg):
        served = [0] * e
        for i in range(g0, g0 + tg):
            row = probs[i].tolist()
            order = sorted(range(e), key=lambda j: (-row[j], j))[:k]
            w = probs[i, order]
            w = w / w.sum().clamp_min(1e-9)
            for choice, j in enumerate(order):
                if served[j] >= cap:
                    continue
                served[j] += 1
                kept.append((i, choice))
                y = _swiglu(x2[i:i + 1], p["w_gate"][j], p["w_up"][j],
                            p["w_down"][j])
                out[i] = out[i] + y[0] * w[choice].to(x.dtype).to(x.device)
    if cfg.moe_dense_ff:
        if cfg.mlp_kind != "swiglu":
            raise ValueError(f"dense FFN kind {cfg.mlp_kind!r}")
        dn = p["dense"]
        out = out + _swiglu(x2, dn["w_gate"], dn["w_up"], dn["w_down"])
    return out.reshape(bsz, s, d), kept

"""Per-lane token sampling for the batched continuous-batching decoder.

Every decode lane carries its own key and its own sampling knobs
(temperature, top-k, top-p), so one batched step samples all lanes at once
while keeping lanes *numerically independent*: lane b's token stream is a
function of lane b's key and lane b's logits alone, so lanes joining or
leaving the batch cannot perturb it.

Key discipline.  JAX's threefry keys cannot be reproduced in torch, so a
lane's key here is the pair ``(seed, token_count)``: the request's seed
(default: the request id) and the number of tokens the lane has drawn.
Each token, the prefill's first one included, draws one uniform from a
counter-based Philox4x32-10 stream keyed on ``seed`` at counter
``token_count``, then advances the count by one.  The draw is computed on
the host in numpy, so the stream is the same on every device.

Greedy lanes (``temperature <= 0``) take the argmax inside the same batched
step, so greedy and sampled requests mix freely in one batch.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)


def make_lane_key(seed: int) -> np.ndarray:
    """Root key of one request/lane as host data: ``(seed, 0)`` int64 (the
    engine keeps a ``(slots, 2)`` host mirror next to tok/idx)."""
    return np.asarray([int(seed), 0], np.int64)


def philox4x32(key, counter):
    """Philox4x32-10 (Salmon et al., SC'11) over numpy uint32 words:
    ``key`` is (k0, k1) and ``counter`` (c0, c1, c2, c3), each a scalar or
    an array; returns the four output words as uint64 arrays < 2**32."""
    k0, k1 = (np.asarray(w, np.uint64) & _MASK for w in key)
    c0, c1, c2, c3 = (np.asarray(w, np.uint64) & _MASK for w in counter)
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2                  # exact: 32 x 32 bits
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_uniform(seed, counter) -> np.ndarray:
    """One uniform in [0, 1) per lane: Philox4x32-10 keyed on the 64-bit
    ``seed`` at the 64-bit ``counter`` (both (B,) arrays), from the top 24
    bits of the first output word."""
    seed = np.asarray(seed).astype(np.uint64)
    counter = np.asarray(counter).astype(np.uint64)
    zero = np.zeros_like(counter)
    w = philox4x32((seed, seed >> np.uint64(32)),
                   (counter, counter >> np.uint64(32), zero, zero))[0]
    return (w >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


def _filter_logits(logits, top_k, top_p):
    """Per-lane top-k and top-p (nucleus) filters on (B, V) logits.
    ``top_k <= 0`` and ``top_p >= 1`` disable them for that lane.
    Value-threshold semantics: ties with the k-th (or nucleus-cutoff) logit
    are kept, as in the reference."""
    v = logits.shape[-1]
    sorted_lg = torch.sort(logits, dim=-1, descending=True).values
    # top-k: drop logits strictly below the lane's k-th largest value
    kth_i = torch.clamp(top_k - 1, 0, v - 1).long()
    kth = torch.gather(sorted_lg, -1, kth_i[:, None])
    drop = (top_k > 0)[:, None] & (logits < kth)
    # top-p: keep the smallest prefix of descending-prob tokens whose
    # cumulative mass reaches p (always at least one token)
    csum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    cut_i = torch.clamp((csum < top_p[:, None]).sum(-1, keepdim=True), 0, v - 1)
    cut = torch.gather(sorted_lg, -1, cut_i)
    drop |= (top_p < 1.0)[:, None] & (logits < cut)
    return torch.where(drop, torch.full_like(logits, NEG_INF), logits)


def sample_lane_tokens(keys, logits, temperature, top_k, top_p):
    """One batched per-lane sampling step.

    keys:        (B, 2) int64 host array of ``(seed, token_count)``
    logits:      (B, V) last-position logits (any device)
    temperature: (B,) float, <= 0 means greedy (argmax) for that lane
    top_k:       (B,) int, 0 disables
    top_p:       (B,) float, >= 1 disables

    Returns ``(next_keys (B, 2) int64 host array, tokens (B,) int64 on
    logits' device)``.  Every lane's count advances by exactly one per call,
    greedy lanes included, so a lane's key depends only on its own token
    count."""
    keys = np.asarray(keys, np.int64)
    dev = logits.device
    logits = logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    u = torch.from_numpy(philox_uniform(keys[:, 0], keys[:, 1])).to(dev)
    greedy = temperature <= 0.0
    safe_t = torch.where(greedy, torch.ones_like(temperature), temperature)
    filtered = _filter_logits(logits / safe_t[:, None], top_k, top_p)
    # inverse CDF of the filtered distribution with the lane's one uniform
    cdf = torch.cumsum(torch.softmax(filtered, dim=-1), dim=-1)
    pick = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    sampled = torch.clamp(pick[:, 0], max=logits.shape[-1] - 1)
    toks = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    nxt = keys.copy()
    nxt[:, 1] += 1
    return nxt, toks

"""Shared arithmetic of the serve cells' readers (loaded by path, as the
readers are)."""
from __future__ import annotations


def ttft_ms(o, limit: float, drain_end_ms: float) -> float:
    """Time to first token from when the request was due; a request that
    failed or never got a token counts past the limit."""
    if o.ok and o.result.ttft_ms > 0:
        return o.result.ttft_ms
    return max(limit, drain_end_ms - o.start_ms)


def tpot_ms(o, limit: float) -> float:
    """(latency - TTFT) / (tokens - 1); past the limit for a failure."""
    if o.ok and len(o.result.tokens) > 1 and o.result.ttft_ms > 0:
        return ((o.result.latency_ms() - o.result.ttft_ms)
                / (len(o.result.tokens) - 1))
    return limit * 2.0

"""Serving traffic from a cell's parameters and a seed.

Every size and arrival comes from a fixed set that the parameters alone
decide, in a fixed order (``FIXED``), and the seed draws the tokens: so
every seed gives the same work at the same times (at 0.8 of the knee the
order of long prompts alone moved a window's tails by half), and the same
seed the same requests.

The loop is open (``"loop": "open"``): ``rate_per_s`` x the window's
seconds requests, due at Poisson-like times (the gaps are the
exponential's quantiles in a fixed order, scaled to fill the window), each
with a prompt of ``prompt`` tokens and ``output`` new tokens drawn from
their distributions' quantiles, and ``deadline_ms`` = base + per output
token.  A length distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "uniform", "min", "max"}``; a set of n lengths is
its quantiles at (i + 0.5) / n, clipped and rounded.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

FIXED = 20250101          # the order of sizes and arrivals: not the run's


@dataclass
class Ask:
    """One request as the generator makes it."""
    index: int
    prompt: np.ndarray            # int32 token ids
    max_new_tokens: int
    deadline_ms: float
    due_s: float = 0.0            # seconds after the window opens


def lengths(spec: Dict, n: int) -> np.ndarray:
    """n lengths: the quantiles of ``spec``'s distribution, ascending."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = spec["min"] + (spec["max"] - spec["min"]) * u
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def deadline(spec: Dict, out_tokens: int) -> float:
    return float(spec["base"] + spec.get("per_output_token", 0) * out_tokens)


class OpenLoop:
    """The requests of one open-loop window, in order of due time."""

    def __init__(self, t: Dict, vocab: int, seed: int, seconds: float):
        self.loop = "open"
        rng = np.random.default_rng(seed)
        order = np.random.default_rng(FIXED)
        n = max(int(round(t["rate_per_s"] * seconds)), 1)
        u = (np.arange(n) + 0.5) / n
        gaps = order.permutation(-np.log1p(-u))
        due = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
        plen = order.permutation(lengths(t["prompt"], n))
        olen = order.permutation(lengths(t["output"], n))
        self.asks = [Ask(i, rng.integers(2, vocab, int(p), dtype=np.int32),
                         int(o), deadline(t["deadline_ms"], int(o)),
                         due_s=float(d))
                     for i, (p, o, d) in enumerate(zip(plen, olen, due))]
        self.warm = warm_asks(t, vocab, rng)


WARM_DEADLINE_MS = 600_000.0   # set-up's requests sent at once: none of
                               # them may be shed for its deadline


def warm_asks(t: Dict, vocab: int, rng) -> List[Ask]:
    """The set-up's requests: ``warm.requests`` prompts of ``warm.prompt``
    tokens (new to every cache) and ``warm.output`` new tokens each."""
    w = t.get("warm", {"requests": 0})
    return [Ask(-1 - i, rng.integers(2, vocab, int(w["prompt"]),
                                     dtype=np.int32), int(w["output"]),
                WARM_DEADLINE_MS)
            for i in range(int(w["requests"]))]


def make(t: Dict, vocab: int, seed: int, seconds: float):
    if t["loop"] == "open":
        return OpenLoop(t, vocab, seed, seconds)
    raise ValueError(f"unknown loop {t['loop']!r}")

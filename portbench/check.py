"""How ``correct`` is decided: the program's outputs against the plain
reference, each compared number beside its limit.

Serving: a sample, drawn from the seed, of the requests the window
finished (the longest of them always in it, then others until
``served_tokens`` served tokens or ``max_requests`` requests).  The
reference runs once over each prompt followed by its served tokens; at
every position where the program served a token, the gap by which that
token's reference logit lies below the reference's best logit.  The
mean gap over the served positions (``mean_logit_gap``) is compared with
the cell's ``mean_logit_gap_limit``: the mixture of experts flips a
routing choice near a tie in any precision, which the widest gap reads
alike in the program and its control, and the mean reads by how often.
``quant`` runs the reference in a lower precision in the program's place:
the gap of the token it would put first (the control).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import transformer as ref


def serve_sample(outcomes, seed: int, spec: Dict[str, Any]
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(prompt, served tokens) of the sampled finished requests."""
    ok = [o for o in outcomes if o.ok]
    if not ok:
        return []
    size = [len(o.ask.prompt) + len(o.result.tokens) for o in ok]
    first = int(np.argmax(size))
    rest = [i for i in np.random.default_rng(seed).permutation(len(ok))
            if i != first]
    picked, served = [first], len(ok[first].result.tokens)
    for i in rest:
        if served >= spec["served_tokens"] or \
                len(picked) >= spec["max_requests"]:
            break
        picked.append(int(i))
        served += len(ok[i].result.tokens)
    return [(np.asarray(ok[i].ask.prompt),
             np.asarray(ok[i].result.tokens)) for i in picked]


def logit_gaps(c: Dict[str, Any], seed: int, sample, device,
               quant: Optional[str] = None) -> List[np.ndarray]:
    """Each sampled request's gaps, one a served position: of its served
    token, or with ``quant`` of the token that precision puts first."""
    seqs, at, want = [], [], []
    for prompt, served in sample:
        full = np.concatenate([prompt, served[:-1]]).astype(np.int64)
        seqs.append(torch.from_numpy(full))
        at.append(torch.arange(len(prompt) - 1, len(full)))
        want.append(torch.from_numpy(served.astype(np.int64)))
    exact = ref.logits_at(c, seed, seqs, at, device)
    if quant is not None:
        low = ref.logits_at(c, seed, seqs, at, device, quant=quant)
        want = [lg.argmax(-1).cpu() for lg in low]
        del low
    gaps = []
    for lg, tok in zip(exact, want):
        best = lg.max(-1).values
        got = lg.gather(-1, tok.to(lg.device)[:, None])[:, 0]
        gaps.append((best - got).cpu().numpy())
    return gaps


def mean_gap(gaps: List[np.ndarray]) -> float:
    """The mean gap over every served position."""
    return float(np.concatenate(gaps).mean())


def served(c: Dict[str, Any], seed: int, sample, spec: Dict[str, Any],
           device) -> Tuple[Dict[str, Dict[str, float]], bool]:
    """The serve cells' checks and whether they pass.  A window that
    finished no request has nothing to compare and is not correct."""
    served_n = float(sum(len(s) for _, s in sample))
    got = mean_gap(logit_gaps(c, seed, sample, device)) if sample else -1.0
    limit = float(spec["mean_logit_gap_limit"])
    checks = {"mean_logit_gap": {"value": got, "limit": limit},
              "served_tokens": {"value": served_n, "limit": 1.0}}
    return checks, bool(sample) and got <= limit


# ------------------------------------------------------------------ training
SILENT = 1e-3      # a leaf whose reference gradient norm is under this
                   # share of the median leaf's moves by round-off alone


def _worst_leaf(got: Dict[str, float], want: Dict[str, float],
                keys) -> float:
    """The largest gap between two per-leaf norms, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = list(keys)
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def train_gaps(got: Dict[str, Any], want: Dict[str, Any]
               ) -> Dict[str, float]:
    """The training cell's compared numbers: the widest relative gap of a
    step's loss, of a leaf's first gradient norm, and of a leaf's change
    over the steps (leaves whose reference gradient is nought to rounding
    left out)."""
    g = want["grad_norm"]
    med = float(np.median(list(g.values())))
    moving = [k for k, v in g.items() if v >= SILENT * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], want["loss"])),
        "grad_norm_gap": _worst_leaf(got["grad_norm"], g, g.keys()),
        "change_gap": _worst_leaf(got["change"], want["change"], moving),
    }


def trained(c: Dict[str, Any], seed: int, first: Dict[str, Any], feed,
            spec: Dict[str, Any], device
            ) -> Tuple[Dict[str, Dict[str, float]], bool]:
    """The training cell's checks: the reference follows the first steps
    on the same rows."""
    from portbench.reference import train as ref
    want = ref.train_steps(c, c["train"], seed, feed, device)
    gaps = train_gaps(first, want)
    checks = {k: {"value": v, "limit": float(spec[f"{k}_limit"])}
              for k, v in gaps.items()}
    return checks, all(x["value"] <= x["limit"] for x in checks.values())

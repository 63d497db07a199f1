"""Shared arithmetic of the training cell's readers (loaded by path, as
the readers are)."""
from __future__ import annotations


def steps_apart(run):
    """(steps wholly inside the profiled slice, steps outside it): the
    benchmark's ``train_step`` spans, each a synchronised step."""
    p = run.profile
    spans = run.spans.named("train_step") if run.spans is not None else []
    inside = [s for s in spans if s[2] >= p.t0 and s[3] <= p.t1]
    outside = [s for s in spans if s[3] < p.t0 or s[2] > p.t1]
    return inside, outside


def seconds(spans) -> float:
    return sum(s[3] - s[2] for s in spans) / 1e9

"""Learning-rate schedules, including minicpm's WSD (warmup-stable-decay):
the port's copy of ``repro.training.schedules``.  ``lr(step)`` is a float32
scalar tensor, computed in float32 as the reference's traced schedule."""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import TrainConfig


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def make_schedule(tc: TrainConfig):
    """Returns lr(step) -> float32 scalar tensor (``step`` an int or a
    0-d integer tensor)."""
    base = tc.learning_rate
    warm = max(tc.warmup_steps, 1)
    total = max(tc.total_steps, warm + 1)

    def warmup(step):
        return torch.clamp_max((step + 1) / _f32(warm), 1.0)

    def frac(step, start, span):
        return torch.clamp((step - start) / _f32(span), 0.0, 1.0)

    if tc.schedule == "constant":
        def fn(step):
            return base * warmup(_f32(step))
    elif tc.schedule == "linear":
        def fn(step):
            s = _f32(step)
            return base * warmup(s) * (1.0 - frac(s, warm,
                                                  max(total - warm, 1)))
    elif tc.schedule == "cosine":
        def fn(step):
            s = _f32(step)
            f = frac(s, warm, max(total - warm, 1))
            return base * warmup(s) * (0.5 * (1.0 + torch.cos(math.pi * f)))
    elif tc.schedule == "wsd":
        # minicpm: warmup -> stable at base -> sharp exponential-ish decay
        # in the final ``wsd_decay_frac`` of training
        decay_steps = max(int(total * tc.wsd_decay_frac), 1)
        stable_end = total - decay_steps

        def fn(step):
            s = _f32(step)
            decay = torch.pow(_f32(0.01), frac(s, stable_end, decay_steps))
            return base * warmup(s) * decay
    else:
        raise ValueError(tc.schedule)
    return fn

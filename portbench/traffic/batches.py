"""Training batches from the seed: step i's batch is ``batch`` rows of
``seq`` token ids, uniform over the vocabulary, drawn on the card by a
generator seeded from (seed, i), so every step's rows differ and the same
seed gives the same batches."""
from __future__ import annotations

import torch

from portbench.weights import group_seed


def batch(t: dict, vocab: int, seed: int, step: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, f"batch{step}"))
    return torch.randint(0, vocab, (t["batch"], t["seq"]), generator=gen,
                         device=device)

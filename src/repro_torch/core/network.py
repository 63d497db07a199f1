"""Injectable link model for the live dispatcher.

The paper ships requests over UDP across WiFi; here links are in-process but
keep the same failure surface: latency, bandwidth and drop probability are
injectable so tests exercise timeout/retry handling deterministically.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.profile import LinkProfile


@dataclass
class Link:
    profile: LinkProfile
    seed: int = 0
    simulate_delay: bool = False         # actually sleep for transfer time

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def send(self, size_kb: float) -> bool:
        """Returns False if the message was 'lost' (UDP semantics)."""
        if self.profile.loss_prob and self._rng.random() < self.profile.loss_prob:
            return False
        if self.simulate_delay:
            time.sleep(self.profile.transfer_time(size_kb) / 1e3)
        return True

    def transfer_ms(self, size_kb: float) -> float:
        return self.profile.transfer_time(size_kb)

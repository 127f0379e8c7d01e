"""Synthetic serving requests (counterpart of `SyntheticRequests` in
`repro/data/pipeline.py`): the same seeds give the same token ids, EOS ids
and arrival cycles."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SyntheticRequests:
    """Requests with prompt lengths drawn from [4, max_prompt].

    `eos_id(i)` samples a per-request EOS token from a small stop alphabet
    (`eos_alphabet` ids), so EOS-aware serving engines see ragged
    completions.  The cost-only engine's synthetic token stream draws from
    the same alphabet (`repro_torch.npec.runtime.engine.SYNTH_ALPHABET`),
    which is what makes the sampled EOS fire."""
    vocab_size: int
    max_prompt: int
    seed: int = 0
    eos_alphabet: int = 32
    # Poisson arrivals for fleet load sweeps: mean requests/sec at the
    # overlay model's clock.  None queues every request at cycle 0.
    rate_rps: Optional[float] = None
    clock_hz: float = 200e6

    def request(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7919 + i)
        n = int(rng.integers(4, self.max_prompt + 1))
        return rng.integers(0, self.vocab_size, (n,), np.int32)

    def eos_id(self, i: int) -> int:
        rng = np.random.default_rng(self.seed * 104729 + i + 1)
        return int(rng.integers(0, min(self.eos_alphabet, self.vocab_size)))

    def arrival_cycles(self, n: int) -> np.ndarray:
        """Arrival cycles of the first `n` requests: a seeded Poisson
        process (cumulative exponential gaps at `rate_rps`, in cycles at
        `clock_hz`); all zeros when `rate_rps` is None."""
        if self.rate_rps is None:
            return np.zeros(n, np.int64)
        rng = np.random.default_rng(self.seed * 52361 + 7)
        gaps = rng.exponential(self.clock_hz / self.rate_rps, n)
        return np.cumsum(gaps).astype(np.int64)

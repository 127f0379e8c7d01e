"""Synthetic serving requests (counterpart of `SyntheticRequests.request` in
`repro/data/pipeline.py`): the same seeds give the same token ids."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticRequests:
    """Requests with prompt lengths drawn from [4, max_prompt]."""
    vocab_size: int
    max_prompt: int
    seed: int = 0

    def request(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7919 + i)
        n = int(rng.integers(4, self.max_prompt + 1))
        return rng.integers(0, self.vocab_size, (n,), np.int32)

"""Synthetic data (counterpart of `repro/data/pipeline.py`): the training
stream `SyntheticLM` and the serving requests `SyntheticRequests`.  The
same seeds give the same token ids, labels, EOS ids and arrival cycles."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticLM:
    """A learnable token stream: within each sequence the next token is a
    fixed affine function of the previous one (a per-sequence
    linear-congruential walk), with epsilon-uniform corruption.

    Host sharding: each host makes only its slice of the global batch,
    `host_batch = global_batch // num_hosts`, selected by (seed, step,
    host_id), so restarts see the same data."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.host_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step` (this host's shard): tokens + next-token labels."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_id)
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        a = rng.integers(1, 64, (B, 1), np.int64) * 2 + 1   # odd multipliers
        c = rng.integers(0, V, (B, 1), np.int64)
        x0 = rng.integers(0, V, (B,), np.int64)
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = x0
        for t in range(S):
            toks[:, t + 1] = (toks[:, t] * a[:, 0] + c[:, 0]) % V
        corrupt = rng.random((B, S + 1)) < self.noise
        toks = np.where(corrupt, rng.integers(0, V, (B, S + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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

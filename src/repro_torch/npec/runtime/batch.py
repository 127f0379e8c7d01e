"""Request queue and decode-slot pool for the compiled serving engine.

A copy of `repro/npec/runtime/batch.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Continuous batching over a *fixed* compiled stream: the engine compiles
ONE batched decode stream with B slots (repro_torch.npec.trace,
`trace_decode(batch=B)`), so the pool is a fixed array of B slots whose
occupants change — a request is admitted into a free slot (compiled
prefill seeds its cache bank), generates one token per engine step, and
is evicted on EOS or its token budget, freeing the slot for the next
queued request.  Admission is strict FIFO, so ragged prompt lengths
cannot starve a request (tests/test_npec_runtime.py gates fairness).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np


@dataclass
class Request:
    """One serving request and its cycle-stamped lifecycle."""
    rid: int
    prompt: np.ndarray                 # (S,) int32 prompt tokens
    max_new_tokens: int
    eos_id: Optional[int] = None
    submit_cycle: int = 0
    admit_cycle: int = -1              # prefill start (slot granted)
    first_token_cycle: int = -1        # prefill done, first token out
    finish_cycle: int = -1
    generated: List[int] = field(default_factory=list)
    # clock timestamp of every emitted token (first token included) — the
    # per-token trace behind inter-token gap percentiles, i.e. the p99
    # cliff the chunked-prefill interleave bounds (clock.inter_token_gaps)
    token_cycles: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.finish_cycle >= 0

    def wants_more(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return False
        if (self.eos_id is not None and self.generated
                and self.generated[-1] == self.eos_id):
            return False
        return True


class RequestQueue:
    """FIFO admission queue."""

    def __init__(self):
        self._q: Deque[Request] = deque()
        self._next_rid = 0

    def submit(self, prompt, *, max_new_tokens: int,
               eos_id: Optional[int] = None, submit_cycle: int = 0
               ) -> Request:
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_id, submit_cycle=submit_cycle)
        self._next_rid += 1
        self._q.append(req)
        return req

    def pop(self) -> Request:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class SlotPool:
    """B decode slots bound to the positions of ONE batched stream."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._slots: List[Optional[Request]] = [None] * n_slots

    def free_ids(self) -> List[int]:
        return [s for s, r in enumerate(self._slots) if r is None]

    def active(self) -> List[tuple]:
        """(slot, request) pairs currently generating."""
        return [(s, r) for s, r in enumerate(self._slots) if r is not None]

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self._slots], bool)

    def bind(self, slot: int, req: Request) -> None:
        assert self._slots[slot] is None, f"slot {slot} is occupied"
        self._slots[slot] = req

    def release(self, slot: int) -> Request:
        req = self._slots[slot]
        assert req is not None, f"slot {slot} is already free"
        self._slots[slot] = None
        return req

    def __len__(self) -> int:
        return sum(r is not None for r in self._slots)

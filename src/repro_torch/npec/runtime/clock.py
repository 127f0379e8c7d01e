"""Cycle clock: deterministic serving time from compiled-stream schedules.

A copy of `repro/npec/runtime/clock.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

The overlay is a single in-order machine clocked at `NPEHardware.clock_hz`
(200 MHz): the ICU consumes one instruction stream at a time, so serving
time is just the sum of the scheduled stream lengths the engine chose to
run — a prefill stream per admitted request, one batched decode stream
per generation step.  `CycleClock` accumulates those cycle counts and
converts them to wall-clock milliseconds at the overlay's frequency;
every latency number the engine reports (p50/p99, tokens/sec) is derived
from this counter, never from host wall-clock, which makes engine runs
bit-reproducible (results/npec_serve_cycles.json is regression-guarded).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class CycleClock:
    """Monotonic cycle counter at a fixed overlay frequency.

    Scheduled stream costs are floats (tile-streaming schedules produce
    fractional totals); the integer timestamp carries the fractional
    remainder between charges instead of rounding every charge
    independently — per-charge `int(round(...))` accumulates up to half a
    cycle of drift PER CHARGE, which diverges from the exact float sum by
    thousands of cycles over a long decode run.  With the carried
    remainder the timestamp stays within half a cycle of the exact sum
    forever (tests/test_npec_buckets.py::test_clock_carries_fractional_
    remainder)."""
    clock_hz: float
    cycles: int = 0
    idle_cycles: int = 0
    _frac: float = 0.0

    def advance(self, cycles: float) -> int:
        """Charge a scheduled stream; returns the new timestamp."""
        if cycles < 0:
            raise ValueError(f"cannot advance by {cycles} cycles")
        t = self._frac + cycles
        step = int(round(t))
        self._frac = t - step
        self.cycles += step
        return self.cycles

    def advance_to(self, cycle: int, *, idle: bool = True) -> int:
        """Jump forward to an absolute timestamp (fleet clock alignment:
        an idle overlay waiting on the shared admission queue skips ahead
        to the next arrival).  Monotonic — rewinding is an error.  The
        jump aligns to an externally-chosen integer cycle, so the carried
        fractional remainder resets.

        `idle` classifies the skipped cycles: a queue-starved wait counts
        toward `idle_cycles` (the per-overlay idle term in the
        observability conservation identity, docs/observability.md);
        a jump that merely aligns this clock to work ALREADY placed on a
        shared timeline (the pipeline hook's chained stage completions)
        passes idle=False — those cycles are busy elsewhere, not idle."""
        if cycle < self.cycles:
            raise ValueError(
                f"cannot rewind the clock from {self.cycles} to {cycle}")
        if idle:
            self.idle_cycles += int(cycle) - self.cycles
        self.cycles = int(cycle)
        self._frac = 0.0
        return self.cycles

    def ms(self, cycles: float = None) -> float:
        """Milliseconds for `cycles` (default: the current timestamp)."""
        c = self.cycles if cycles is None else cycles
        return 1e3 * c / self.clock_hz


def inter_token_gaps(requests) -> List[int]:
    """Consecutive-token decode gaps, in cycles, across every request's
    `token_cycles` trace (first-token gaps excluded — a request's first
    gap is token 1 -> token 2).  This is the series whose tail a
    mid-decode prefill stall inflates: an unchunked admit inserts the
    whole prompt's stream between two decode steps, a chunked admit at
    most one slice's (the p99-cliff gate in tests/test_npec_runtime.py
    and the npec_disagg record both read it)."""
    gaps: List[int] = []
    for r in requests:
        ts = r.token_cycles
        gaps.extend(b - a for a, b in zip(ts, ts[1:]))
    return gaps


@dataclass
class LatencyTracker:
    """Per-request latency aggregation over clock timestamps (cycles)."""
    clock: CycleClock
    samples_ms: List[float] = field(default_factory=list)

    def record(self, start_cycle: int, end_cycle: int) -> float:
        ms = self.clock.ms(end_cycle - start_cycle)
        self.samples_ms.append(ms)
        return ms

    def percentiles(self, ps=(50, 99)) -> Dict[str, float]:
        if not self.samples_ms:
            return {f"p{p}_ms": 0.0 for p in ps}
        lat = np.asarray(self.samples_ms)
        return {f"p{p}_ms": round(float(np.percentile(lat, p)), 4)
                for p in ps}

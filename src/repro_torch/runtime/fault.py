"""Fault tolerance: failure detection, rewind-to-checkpoint, stragglers
(counterpart of `repro/runtime/fault.py`).

The supervisor wraps the training loop with:
  * NaN/inf loss detection   -> rewind to the latest checkpoint
  * injected crashes         -> simulated node failure (tests/examples)
  * per-step deadline        -> straggler mitigation events (in a real
    multi-host deployment this triggers the slow host's eviction and an
    elastic restart; here the event is recorded)
  * bounded restarts         -> gives up after max_restarts (a real crash
    loop must page a human)
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.config import FaultConfig


class TrainingFailure(Exception):
    pass


@dataclass
class FaultEvent:
    step: int
    kind: str          # nan | crash | straggler
    action: str        # rewind | record | abort
    detail: str = ""


@dataclass
class Supervisor:
    cfg: FaultConfig
    events: List[FaultEvent] = field(default_factory=list)
    restarts: int = 0

    def check_loss(self, step: int, loss: float):
        if self.cfg.inject_nan_at_step == step and self.restarts == 0:
            loss = float("nan")
        if self.cfg.nan_is_failure and not math.isfinite(loss):
            self.events.append(FaultEvent(step, "nan", "rewind",
                                          f"loss={loss}"))
            raise TrainingFailure(f"non-finite loss at step {step}")

    def check_crash(self, step: int):
        if self.cfg.inject_crash_at_step == step and self.restarts == 0:
            self.events.append(FaultEvent(step, "crash", "rewind",
                                          "injected node failure"))
            raise TrainingFailure(f"injected crash at step {step}")

    def check_deadline(self, step: int, elapsed: float):
        if self.cfg.step_deadline_sec > 0 \
                and elapsed > self.cfg.step_deadline_sec:
            self.events.append(FaultEvent(
                step, "straggler", "record",
                f"step took {elapsed:.2f}s > {self.cfg.step_deadline_sec}s"))

    def on_failure(self) -> bool:
        """Returns True if the loop should restart from checkpoint."""
        self.restarts += 1
        return self.restarts <= self.cfg.max_restarts


def run_with_recovery(train_loop: Callable[[int], Dict[str, Any]],
                      restore: Callable[[], int],
                      supervisor: Supervisor) -> Dict[str, Any]:
    """Drive `train_loop(start_step)` with rewind-on-failure.

    `restore()` reloads state from the latest checkpoint and returns the
    step to resume from.  `train_loop` runs until completion or raises
    TrainingFailure.
    """
    start = 0
    while True:
        try:
            return train_loop(start)
        except TrainingFailure as e:
            if not supervisor.on_failure():
                raise TrainingFailure(
                    f"exceeded max_restarts={supervisor.cfg.max_restarts}: "
                    f"{e}") from e
            start = restore()

"""Cycle-domain metrics: counters, labeled counter families, exact histograms.

A copy of `repro/npec/obs/metrics.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Everything in this module is derived from integer cycle counts (or other
deterministic integers) — no wall clock anywhere.  Two identical runs
produce byte-identical ``snapshot()`` dicts, which is what lets the
serving reports, ``results/*.json`` records, and exported traces all be
regression-guarded bit-exactly.

The registry subsumes the hand-rolled counter fields that used to live on
``EngineStats`` / ``FleetStats`` (decode_steps, prefills, bucket
migrations, ...): those dataclasses now expose compatibility properties
backed by a :class:`MetricsRegistry`, and ``report()`` is built from
``snapshot()``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


class Counter:
    """A monotonically increasing integer (or float) counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0):
        self.name = name
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class CycleHistogram:
    """Exact-count histogram over integer cycle values.

    Buckets are powers of two: a sample ``v`` lands in the smallest
    bucket with upper bound ``2**k >= v`` (``v == 0`` lands in ``le_1``).
    Counts are exact integers; ``sum`` is the exact integer total, so the
    histogram carries no floating-point noise and snapshots are
    deterministic.
    """

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0
        self.vmin: Optional[int] = None
        self.vmax: Optional[int] = None
        self._buckets: Dict[int, int] = {}  # upper bound (2**k) -> count

    def observe(self, value: int) -> None:
        v = int(value)
        if v < 0:
            raise ValueError(f"negative cycle sample for {self.name}: {v}")
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        bound = 1
        while bound < v:
            bound <<= 1
        self._buckets[bound] = self._buckets.get(bound, 0) + 1

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "buckets": {f"le_{b}": self._buckets[b] for b in sorted(self._buckets)},
        }


class MetricsRegistry:
    """A named collection of counters, counter families, and histograms.

    * ``inc(name)`` — plain counter.
    * ``inc(name, label=x)`` — labeled counter family (e.g. decode steps
      keyed by bucket, charged cycles keyed by charge kind).
    * ``observe(name, cycles)`` — exact cycle histogram.

    ``snapshot()`` renders all of it into one deterministic dict with
    sorted label keys; ``merge(other)`` folds a child registry (e.g. a
    per-engine registry into the fleet's).
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._families: Dict[str, Dict[object, float]] = {}
        self._hists: Dict[str, CycleHistogram] = {}

    # -- counters ---------------------------------------------------------
    def inc(self, name: str, n: float = 1, label: object = None) -> None:
        if label is None:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            c.inc(n)
        else:
            fam = self._families.setdefault(name, {})
            fam[label] = fam.get(label, 0) + n

    def value(self, name: str, label: object = None, default: float = 0) -> float:
        if label is None:
            c = self._counters.get(name)
            return c.value if c is not None else default
        return self._families.get(name, {}).get(label, default)

    def family(self, name: str) -> Dict[object, float]:
        """Return a copy of a labeled counter family, sorted by label
        (natural order when the labels are mutually orderable — integer
        bucket labels sort numerically — repr order otherwise)."""
        fam = self._families.get(name, {})
        try:
            keys = sorted(fam)
        except TypeError:
            keys = sorted(fam, key=repr)
        return {k: fam[k] for k in keys}

    # -- histograms -------------------------------------------------------
    def observe(self, name: str, cycles: int) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = CycleHistogram(name)
        h.observe(cycles)

    def histogram(self, name: str) -> Optional[CycleHistogram]:
        return self._hists.get(name)

    # -- aggregation ------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry (exact integer addition)."""
        for name, c in other._counters.items():
            self.inc(name, c.value)
        for name, fam in other._families.items():
            for label, v in fam.items():
                self.inc(name, v, label=label)
        for name, h in other._hists.items():
            mine = self._hists.get(name)
            if mine is None:
                mine = self._hists[name] = CycleHistogram(name)
            mine.count += h.count
            mine.total += h.total
            for attr in ("vmin", "vmax"):
                theirs = getattr(h, attr)
                if theirs is None:
                    continue
                ours = getattr(mine, attr)
                pick = min if attr == "vmin" else max
                setattr(mine, attr, theirs if ours is None else pick(ours, theirs))
            for b, n in h._buckets.items():
                mine._buckets[b] = mine._buckets.get(b, 0) + n

    def snapshot(self) -> dict:
        return {
            "counters": {k: self._counters[k].value for k in sorted(self._counters)},
            "families": {
                name: {repr(label) if not isinstance(label, str) else label: v
                       for label, v in self.family(name).items()}
                for name in sorted(self._families)
            },
            "histograms": {k: self._hists[k].snapshot() for k in sorted(self._hists)},
        }

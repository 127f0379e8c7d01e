"""PWL table builder in numpy (counterpart of `repro/core/pwl.py`).

Adaptive segmentation by greedy error bisection, nodal values refined by
least squares, and guard segments at +-65536 that make range limiting part
of the table.  The guards give `exp` and `gelu` two segments more than
asked for (18 at 16), so consumers take the segment count from the table.
Only the functions the BERT path uses are built: exp, gelu, recip, rsqrt.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np


class PWLTable(NamedTuple):
    """Knots and nodal values, plus the slope/intercept form of each segment."""
    knots: np.ndarray        # (S+1,) float32, strictly increasing
    values: np.ndarray       # (S+1,) float32
    slopes: np.ndarray       # (S,)   float32
    intercepts: np.ndarray   # (S,)   float32

    @property
    def num_segments(self) -> int:
        return self.slopes.shape[0]


def _mk_table(knots: np.ndarray, values: np.ndarray) -> PWLTable:
    knots = np.asarray(knots, np.float64)
    values = np.asarray(values, np.float64)
    dx = np.diff(knots)
    if np.any(dx <= 0):
        raise ValueError("knots must be strictly increasing")
    slopes = np.diff(values) / dx
    intercepts = values[:-1] - slopes * knots[:-1]
    return PWLTable(
        np.asarray(knots, np.float32),
        np.asarray(values, np.float32),
        np.asarray(slopes, np.float32),
        np.asarray(intercepts, np.float32),
    )


def _seg_err(fn, a: float, b: float, grid: int = 64) -> float:
    """Max |f - line| on [a,b] for the chord interpolant."""
    xs = np.linspace(a, b, grid)
    fa, fb = fn(np.array([a]))[0], fn(np.array([b]))[0]
    line = fa + (fb - fa) * (xs - a) / max(b - a, 1e-300)
    return float(np.max(np.abs(fn(xs) - line)))


def _adaptive_lsq_table(fn: Callable[[np.ndarray], np.ndarray], lo: float,
                        hi: float, segments: int, grid: int = 4096) -> PWLTable:
    """Split the segment of largest chord error at its point of largest
    deviation until `segments` exist, then fit the nodal values by LSQ."""
    if segments < 1:
        raise ValueError("need >= 1 segment")
    knots = [float(lo), float(hi)]
    errs = [_seg_err(fn, lo, hi)]
    while len(errs) < segments:
        i = int(np.argmax(errs))
        a, b = knots[i], knots[i + 1]
        xs = np.linspace(a, b, 65)[1:-1]
        fa, fb = fn(np.array([a]))[0], fn(np.array([b]))[0]
        line = fa + (fb - fa) * (xs - a) / (b - a)
        m = float(xs[int(np.argmax(np.abs(fn(xs) - line)))])
        knots.insert(i + 1, m)
        errs[i:i + 1] = [_seg_err(fn, a, m), _seg_err(fn, m, b)]
    karr = np.array(knots)
    return _mk_table(karr, _lsq_nodal_values(fn, karr, grid))


def _lsq_nodal_values(fn, knots: np.ndarray, grid: int) -> np.ndarray:
    """Best nodal values for fixed knots: least squares over hat functions."""
    xs = np.linspace(knots[0], knots[-1], grid)
    n = len(knots)
    seg = np.clip(np.searchsorted(knots, xs, side="right") - 1, 0, n - 2)
    d = (xs - knots[seg]) / (knots[seg + 1] - knots[seg])
    basis = np.zeros((grid, n))
    basis[np.arange(grid), seg] = 1.0 - d
    basis[np.arange(grid), seg + 1] += d
    sol, *_ = np.linalg.lstsq(basis, fn(xs), rcond=None)
    return sol


_erf_np = np.vectorize(math.erf, otypes=[np.float64])

# Evaluation interval per function; recip and rsqrt see mantissas in [0.25, 1).
_FUNCS: dict[str, tuple[Callable, float, float]] = {
    "exp": (np.exp, -18.0, 0.0),
    "gelu": (lambda x: 0.5 * x * (1 + _erf_np(x / np.sqrt(2.0))), -6.0, 6.0),
    "recip": (lambda x: 1.0 / x, 0.25, 1.0),
    "rsqrt": (lambda x: 1.0 / np.sqrt(x), 0.25, 1.0),
}

# Tail of each side outside the core interval: "sat" is flat at the boundary
# value, "asym" interpolates to the exact value at +-_GUARD.
_GUARD = 65536.0
_TAILS: dict[str, Optional[tuple[str, str]]] = {
    "exp": ("sat", "sat"),
    "gelu": ("sat", "asym"),
    "recip": None,
    "rsqrt": None,
}


def _add_guards(table: PWLTable, f, tails: tuple[str, str]) -> PWLTable:
    knots = np.asarray(table.knots, np.float64)
    values = np.asarray(table.values, np.float64)
    left, right = tails
    lv = values[0] if left == "sat" else float(f(np.array([-_GUARD]))[0])
    rv = values[-1] if right == "sat" else float(f(np.array([_GUARD]))[0])
    knots = np.concatenate([[-_GUARD], knots, [_GUARD]])
    values = np.concatenate([[lv], values, [rv]])
    return _mk_table(knots, values)


@lru_cache(maxsize=None)
def get_table(name: str, segments: int = 16) -> PWLTable:
    """The adaptive+LSQ table of `name` with `segments` core segments."""
    if name not in _FUNCS:
        raise KeyError(f"no PWL function {name!r}; have {sorted(_FUNCS)}")
    fn, lo, hi = _FUNCS[name]
    f = lambda x: np.asarray(fn(np.asarray(x, np.float64)), np.float64)
    t = _adaptive_lsq_table(f, lo, hi, segments)
    tails = _TAILS[name]
    if tails is not None:
        t = _add_guards(t, f, tails)
    return t

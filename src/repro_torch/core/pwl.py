"""PWL tables, built in numpy (counterpart of `repro/core/pwl.py`, paper §4.2).

Three segmentations: uniform, adaptive (greedy error bisection, nodal
values on the function) and adaptive+lsq (the same knots, nodal values
refined by least squares; the default).  Guard segments at +-65536 make
range limiting part of the table, so they give every guarded table two
segments more than asked for (18 at 16) and consumers take the segment
count from the table.  Every table equals the reference's bit for bit.
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


def uniform_table(fn: Callable[[np.ndarray], np.ndarray], lo: float, hi: float,
                  segments: int) -> PWLTable:
    """Equal-width segments, nodal values on the function."""
    knots = np.linspace(lo, hi, segments + 1)
    return _mk_table(knots, fn(knots))


def adaptive_table(fn: Callable[[np.ndarray], np.ndarray], lo: float, hi: float,
                   segments: int, lsq_refine: bool = True,
                   grid: int = 4096) -> PWLTable:
    """Split the segment of largest chord error at its point of largest
    deviation until `segments` exist; nodal values on the function, or
    refined by least squares with `lsq_refine`."""
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
    values = _lsq_nodal_values(fn, karr, grid) if lsq_refine else fn(karr)
    return _mk_table(karr, values)


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

# Evaluation interval per function; inputs are range-limited to it.  exp
# sees softmax operands <= 0; recip, rsqrt and sqrt see mantissas in
# [0.25, 1); exp_neg_exp is rwkv6's decay exp(-exp(x)), tabulated whole.
_FUNCS: dict[str, tuple[Callable, float, float]] = {
    "exp": (np.exp, -18.0, 0.0),
    "gelu": (lambda x: 0.5 * x * (1 + _erf_np(x / np.sqrt(2.0))), -6.0, 6.0),
    "erf": (_erf_np, -4.0, 4.0),
    "tanh": (np.tanh, -5.0, 5.0),
    "sigmoid": (lambda x: 1 / (1 + np.exp(-x)), -12.0, 12.0),
    "silu": (lambda x: x / (1 + np.exp(-x)), -12.0, 12.0),
    "softplus": (lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0), -14.0, 14.0),
    "recip": (lambda x: 1.0 / x, 0.25, 1.0),
    "rsqrt": (lambda x: 1.0 / np.sqrt(x), 0.25, 1.0),
    "sqrt": (np.sqrt, 0.25, 1.0),
    "relu2": (lambda x: np.maximum(x, 0.0) ** 2, -4.0, 4.0),
    "exp_neg_exp": (lambda x: np.exp(-np.exp(np.clip(x, -40, 20))), -8.0, 3.0),
}

# Tail of each side outside the core interval: "sat" is flat at the boundary
# value, "asym" interpolates to the exact value at +-_GUARD.  None: no guard
# segments (mantissa inputs; relu2 is computed by max and multiply).
_GUARD = 65536.0
_TAILS: dict[str, Optional[tuple[str, str]]] = {
    "exp": ("sat", "sat"),
    "gelu": ("sat", "asym"),
    "erf": ("sat", "sat"),
    "tanh": ("sat", "sat"),
    "sigmoid": ("sat", "sat"),
    "silu": ("sat", "asym"),
    "softplus": ("sat", "asym"),
    "recip": None,
    "rsqrt": None,
    "sqrt": None,
    "relu2": None,
    "exp_neg_exp": ("sat", "sat"),
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


def table_max_error(fn, table: PWLTable, grid: int = 65536,
                    lo: Optional[float] = None, hi: Optional[float] = None) -> float:
    """Max |f - pwl| over [lo, hi]; by default the table's core interval,
    without its guard segments."""
    knots = np.asarray(table.knots, np.float64)
    if lo is None:
        lo = knots[1] if knots[0] <= -_GUARD else knots[0]
    if hi is None:
        hi = knots[-2] if knots[-1] >= _GUARD else knots[-1]
    xs = np.linspace(lo, hi, grid)
    return float(np.max(np.abs(fn(xs) - eval_pwl_np(table, xs))))


def eval_pwl_np(table: PWLTable, x: np.ndarray) -> np.ndarray:
    """Evaluation in float64 numpy, for checking tables."""
    knots = np.asarray(table.knots, np.float64)
    slopes = np.asarray(table.slopes, np.float64)
    icepts = np.asarray(table.intercepts, np.float64)
    seg = np.clip(np.searchsorted(knots, x, side="right") - 1, 0, len(slopes) - 1)
    return slopes[seg] * x + icepts[seg]


@lru_cache(maxsize=None)
def get_table(name: str, segments: int = 16, strategy: str = "adaptive+lsq") -> PWLTable:
    """The table of `name` with `segments` core segments, by `strategy`:
    "uniform", "adaptive" (chord values) or "adaptive+lsq" (the default:
    least-squares nodal values, whose errors change sign and cancel in
    softmax's sum where a convex function's chord errors would add up)."""
    if name not in _FUNCS:
        raise KeyError(f"no PWL function {name!r}; have {sorted(_FUNCS)}")
    fn, lo, hi = _FUNCS[name]
    f = lambda x: np.asarray(fn(np.asarray(x, np.float64)), np.float64)
    if strategy == "uniform":
        t = uniform_table(f, lo, hi, segments)
    elif strategy == "adaptive":
        t = adaptive_table(f, lo, hi, segments, lsq_refine=False)
    elif strategy == "adaptive+lsq":
        t = adaptive_table(f, lo, hi, segments, lsq_refine=True)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    tails = _TAILS[name]
    if tails is not None:
        t = _add_guards(t, f, tails)
    return t


def available_functions() -> list[str]:
    return sorted(_FUNCS)

"""The NVU in plain torch, float mode (counterpart of `repro/core/nvu.py`).

Every nonlinearity is a continuous piecewise-linear table (core/pwl.py) plus
vector arithmetic.  Scale-free functions (1/x, 1/sqrt(x)) are evaluated on
the mantissa and denormalized by an exact power of two.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import pwl


def _table_tensors(table: pwl.PWLTable, device: torch.device):
    return (torch.as_tensor(table.knots, device=device),
            torch.as_tensor(table.slopes, device=device),
            torch.as_tensor(table.intercepts, device=device))


def pwl_eval(x: torch.Tensor, table: pwl.PWLTable) -> torch.Tensor:
    """Evaluate a CPWL table: seg(x) = sum_i 1[x >= knot_i] over the interior
    knots, then slope[seg] * x + intercept[seg].  Outside the knots the edge
    segments extrapolate."""
    dt = x.dtype
    xf = x.to(torch.float32)
    knots, slopes, icepts = _table_tensors(table, x.device)
    seg = (xf[..., None] >= knots[1:-1]).sum(-1)
    return (slopes[seg] * xf + icepts[seg]).to(dt)


def pwl_eval_clamped(x: torch.Tensor, table: pwl.PWLTable) -> torch.Tensor:
    """Evaluate with range limiting (clamp to the table interval)."""
    xf = torch.clamp(x.to(torch.float32), float(table.knots[0]),
                     float(table.knots[-1]))
    return pwl_eval(xf, table).to(x.dtype)


def _normalize_pow4(x: torch.Tensor):
    """Decompose positive x = m * 4^p with m in [0.25, 1)."""
    m, e = torch.frexp(x.to(torch.float32))          # m in [0.5, 1)
    odd = (e % 2) != 0
    m = torch.where(odd, m * 0.5, m)
    e = torch.where(odd, e + 1, e)
    return m, torch.div(e, 2, rounding_mode="floor")


def nvu_reciprocal(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """1/x for x > 0 via mantissa-normalized PWL (no divider)."""
    t = pwl.get_table("recip", segments)
    m, e = torch.frexp(x.to(torch.float32))
    r = pwl_eval_clamped(m, t)
    return torch.ldexp(r, -e).to(x.dtype)


def nvu_rsqrt(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """1/sqrt(x) for x > 0 via power-of-4 normalized PWL (no sqrt unit)."""
    t = pwl.get_table("rsqrt", segments)
    m, p = _normalize_pow4(x)
    r = pwl_eval_clamped(m, t)
    return torch.ldexp(r, -p).to(x.dtype)


def nvu_gelu(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """GELU; its right tail is asymptotically linear, so it extrapolates."""
    return pwl_eval(x, pwl.get_table("gelu", segments))


def nvu_exp(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """exp for x <= 0, floored at 0 (LSQ values can dip below zero)."""
    return torch.clamp(pwl_eval_clamped(x, pwl.get_table("exp", segments)), min=0)


def nvu_softmax(x: torch.Tensor, axis: int = -1, segments: int = 16,
                where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax: max, subtract, PWL exp, sum, PWL reciprocal.  Rows that are
    masked out entirely come out as zeros."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if where is not None:
        xf = torch.where(where, xf, -torch.inf)
    m = xf.amax(dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = nvu_exp(xf - m, segments)
    if where is not None:
        e = torch.where(where, e, 0.0)
    s = e.sum(dim=axis, keepdim=True)
    out = e * nvu_reciprocal(torch.clamp(s, min=1e-30), segments)
    return out.to(dt)


def nvu_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                  beta: Optional[torch.Tensor], eps: float = 1e-5,
                  axis: int = -1, segments: int = 16) -> torch.Tensor:
    """LayerNorm: mean and variance by reductions, 1/sqrt by PWL."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=axis, keepdim=True)
    var = torch.square(xf - mu).mean(dim=axis, keepdim=True)
    inv = nvu_rsqrt(var + eps, segments)
    y = (xf - mu) * inv
    y = y * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(dt)


_EXACT = {"gelu": lambda x: F.gelu(x, approximate="none")}
_NVU = {"gelu": nvu_gelu}


def activation(name: str, use_pwl: bool, segments: int = 16):
    """The activation callable: exact, or through the PWL engine."""
    if use_pwl:
        fn = _NVU[name]
        return lambda x: fn(x, segments=segments)
    return _EXACT[name]


def softmax(x: torch.Tensor, axis: int = -1, use_pwl: bool = False,
            segments: int = 16, where: Optional[torch.Tensor] = None):
    if use_pwl:
        return nvu_softmax(x, axis=axis, segments=segments, where=where)
    if where is not None:
        x = torch.where(where, x, -torch.inf)
    out = torch.softmax(x, dim=axis)
    if where is not None:
        out = torch.where(where, out, 0.0)
    return out

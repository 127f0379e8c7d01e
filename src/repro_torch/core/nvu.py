"""The NVU in plain torch (counterpart of `repro/core/nvu.py`, paper §4, §6).

Every nonlinearity is a continuous piecewise-linear table (core/pwl.py) plus
vector arithmetic.  Scale-free functions (1/x, 1/sqrt(x)) are evaluated on
the mantissa and denormalized by an exact power of two.  Two modes: float
(PWL in float32) and fixed (`fixed=True`), which quantizes every
intermediate to the datapath's Q-formats (core/fixedpoint.py).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import fixedpoint as fp
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


def _elementwise(name: str, extrapolate: bool):
    """Saturating functions clamp to the table interval; functions with
    asymptotically linear tails (gelu, silu, softplus) extrapolate the edge
    segments.  `fixed` quantizes the input and the result to Q16.8."""
    def f(x: torch.Tensor, segments: int = 16, fixed: bool = False) -> torch.Tensor:
        t = pwl.get_table(name, segments)
        ev = pwl_eval if extrapolate else pwl_eval_clamped
        if fixed:
            y = ev(fp.quantize(x, fp.Q16_8), t)
            return fp.quantize(y, fp.Q16_8).to(x.dtype)
        return ev(x, t)
    f.__name__ = f"nvu_{name}"
    return f


nvu_gelu = _elementwise("gelu", extrapolate=True)
nvu_tanh = _elementwise("tanh", extrapolate=False)
nvu_sigmoid = _elementwise("sigmoid", extrapolate=False)
nvu_silu = _elementwise("silu", extrapolate=True)
nvu_erf = _elementwise("erf", extrapolate=False)
nvu_softplus = _elementwise("softplus", extrapolate=True)
nvu_exp_neg_exp = _elementwise("exp_neg_exp", extrapolate=False)  # rwkv6 decay


def nvu_relu2(x: torch.Tensor, segments: int = 16, fixed: bool = False) -> torch.Tensor:
    """ReLU^2 needs no table: max and multiply are NVU vector ops."""
    r = torch.clamp(x, min=0)
    y = r * r
    if fixed:
        y = fp.quantize(y, fp.Q16_8).to(x.dtype)
    return y


def nvu_exp(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """exp for x <= 0, floored at 0 (LSQ values can dip below zero)."""
    return torch.clamp(pwl_eval_clamped(x, pwl.get_table("exp", segments)), min=0)


def nvu_softmax(x: torch.Tensor, axis: int = -1, segments: int = 16,
                fixed: bool = False,
                where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax: max, subtract, PWL exp, sum, PWL reciprocal.  Rows that are
    masked out entirely come out as zeros.  `fixed`: the exponent in Q16.8
    (clamped to [-18, 0]), exp in Q16.12, the sum in Q32.16, the result in
    Q16.12."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if where is not None:
        xf = torch.where(where, xf, -torch.inf)
    m = xf.amax(dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    z = xf - m
    if fixed:
        z = fp.quantize(torch.clamp(z, -18.0, 0.0), fp.Q16_8)
    e = nvu_exp(z, segments)
    if where is not None:
        e = torch.where(where, e, 0.0)
    if fixed:
        e = fp.quantize(e, fp.Q16_12)
        s = fp.fixed_sum(e, axis, fp.Q32_16)
    else:
        s = e.sum(dim=axis, keepdim=True)
    out = e * nvu_reciprocal(torch.clamp(s, min=1e-30), segments)
    if fixed:
        out = fp.quantize(out, fp.Q16_12)
    return out.to(dt)


def nvu_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                  beta: Optional[torch.Tensor], eps: float = 1e-5,
                  axis: int = -1, segments: int = 16,
                  fixed: bool = False) -> torch.Tensor:
    """LayerNorm: mean and variance by reductions, 1/sqrt by PWL.  `fixed`:
    the input in Q16.8, mean and variance in Q32.16, the normalized value in
    Q16.12, the result in Q16.8."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if fixed:
        xf = fp.quantize(xf, fp.Q16_8)
    mu = xf.mean(dim=axis, keepdim=True)
    var = torch.square(xf - mu).mean(dim=axis, keepdim=True)
    if fixed:
        mu = fp.quantize(mu, fp.Q32_16)
        var = fp.quantize(var, fp.Q32_16)
    inv = nvu_rsqrt(var + eps, segments)
    y = (xf - mu) * inv
    if fixed:
        y = fp.quantize(y, fp.Q16_12)
    y = y * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    if fixed:
        y = fp.quantize(y, fp.Q16_8)
    return y.to(dt)


def nvu_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
                axis: int = -1, segments: int = 16,
                fixed: bool = False) -> torch.Tensor:
    """RMSNorm: mean square by a reduction, 1/sqrt by PWL; `fixed` as for
    `nvu_layernorm`."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if fixed:
        xf = fp.quantize(xf, fp.Q16_8)
    ms = torch.square(xf).mean(dim=axis, keepdim=True)
    if fixed:
        ms = fp.quantize(ms, fp.Q32_16)
    y = xf * nvu_rsqrt(ms + eps, segments)
    if fixed:
        y = fp.quantize(y, fp.Q16_12)
    y = y * gamma.to(torch.float32)
    if fixed:
        y = fp.quantize(y, fp.Q16_8)
    return y.to(dt)


_EXACT = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu2": lambda x: torch.square(F.relu(x)),
    "softplus": F.softplus,
    "exp_neg_exp": lambda x: torch.exp(-torch.exp(x)),
    "erf": torch.erf,
}

_NVU = {
    "gelu": nvu_gelu,
    "silu": nvu_silu,
    "tanh": nvu_tanh,
    "sigmoid": nvu_sigmoid,
    "relu2": nvu_relu2,
    "softplus": nvu_softplus,
    "exp_neg_exp": nvu_exp_neg_exp,
    "erf": nvu_erf,
}


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

"""NVU layernorm / rmsnorm kernel (counterpart of `repro/kernels/nvu_layernorm.py`).

`nvu_layernorm(x2d, ...)` launches `csrc/nvu_layernorm.cu` for a tensor on
the card and runs `nvu_layernorm_plain` for one on the CPU.

`nvu_layernorm_grad(x, dy, gamma, ...)` is the backward of the training
path, (dx, dgamma, dbeta) as jax.grad of the reference's
`core/nvu.nvu_layernorm` (or `nvu_rmsnorm`) gives them: the same source's
backward kernels on the card (the row pass: dx and each block's column
sums; then their reduction to dgamma and dbeta in a fixed order), and
`nvu_layernorm_grad_plain`, explicit torch formulas, on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.core.pwl import get_table
from repro_torch.kernels.pwl_eval import (KERNEL_DTYPES, clip_factor, device_table,
                                          pwl_slope_plain, slope_table, table_ends)

MAX_COLS = 8192      # rows past 2048 columns are staged in shared memory


def nvu_layernorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor], eps: float = 1e-5,
                        segments: int = 16, rms_only: bool = False) -> torch.Tensor:
    """Mean and variance in f32, PWL 1/sqrt, then x gamma + beta, as
    `core/nvu.py` computes it; rms_only drops the mean and beta."""
    xf = x.to(torch.float32)
    if rms_only:
        xc = xf
    else:
        xc = xf - xf.mean(dim=-1, keepdim=True)
    var = torch.square(xc).mean(dim=-1, keepdim=True)
    y = xc * nvu.nvu_rsqrt(var + eps, segments)
    y = y * gamma.to(torch.float32)
    if not rms_only and beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x.dtype)


def nvu_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                  beta: Optional[torch.Tensor], eps: float = 1e-5,
                  segments: int = 16, rms_only: bool = False) -> torch.Tensor:
    """Normalize the rows of a 2-D f32 or bf16 tensor; the result has x's dtype."""
    if x.ndim != 2:
        raise ValueError(f"nvu_layernorm takes a 2-D tensor, got {tuple(x.shape)}")
    rows, n = x.shape
    if gamma.numel() != n or (beta is not None and beta.numel() != n):
        raise ValueError(f"nvu_layernorm: gamma/beta do not match {n} columns")
    if x.device.type == "cpu":
        return nvu_layernorm_plain(x, gamma, beta, eps, segments, rms_only)
    require_cuda(x, "nvu_layernorm")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"nvu_layernorm: dtype {x.dtype} not in {KERNEL_DTYPES}")
    if n > MAX_COLS:
        raise ValueError(f"nvu_layernorm: rows of {n} > {MAX_COLS} columns")
    x = x.contiguous()
    g = gamma.to(torch.float32).contiguous()
    b = None if rms_only or beta is None else beta.to(torch.float32).contiguous()
    for t in (g, b):
        if t is not None and t.device != x.device:
            raise ValueError(f"nvu_layernorm: operands on {x.device} and {t.device}")
    y = torch.empty_like(x)
    tab = device_table("rsqrt", segments, x.device)
    err = library().npe_nvu_layernorm(
        x.data_ptr(), y.data_ptr(), g.data_ptr(),
        None if b is None else b.data_ptr(), rows, n,
        int(x.dtype == torch.bfloat16), eps, int(rms_only), tab.data_ptr(),
        tab.shape[1] - 1, stream_handle(x))
    check(err, "nvu_layernorm")
    LAUNCHES["nvu_layernorm"] += 1
    return y


def nvu_layernorm_grad_plain(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                             eps: float = 1e-5, segments: int = 16, rms_only: bool = False):
    """(dx in x's dtype, dgamma f32, dbeta f32 (None with rms_only)) of
    nvu_layernorm against dy: through the PWL 1/sqrt of v = var + eps, the
    rsqrt table's slope at the power-of-4 mantissa m times 2^-p, 1/2 where
    m ties the clip at 0.25, 1/2 more for an odd exponent, 2^-e from
    frexp; then the variance's 2 (x - mu) / n and the mean's -sum / n."""
    xf = x.to(torch.float32)
    n = x.shape[-1]
    d = xf if rms_only else xf - xf.mean(dim=-1, keepdim=True)
    v = torch.square(d).mean(dim=-1, keepdim=True) + eps
    mant, e = torch.frexp(v)
    odd = (e % 2) != 0
    m = torch.where(odd, mant * 0.5, mant)
    p = torch.where(odd, e + 1, e) // 2
    table = get_table("rsqrt", segments)
    lo, hi = table_ends("rsqrt", segments)
    mc = torch.clamp(m, lo, hi)
    inv = torch.ldexp(nvu.pwl_eval(mc, table), -p)
    dyf = dy.to(torch.float32)
    g_y = dyf * gamma.to(torch.float32)
    g_inv = (g_y * d).sum(dim=-1, keepdim=True)
    g_v = torch.ldexp(g_inv, -p) * pwl_slope_plain(mc, table) * clip_factor(m, lo, hi)
    g_v = torch.where(odd, g_v * 0.5, g_v)
    g_sq = torch.ldexp(g_v, -e) / n
    g_d = g_y * inv + g_sq * (2.0 * d)
    if not rms_only:
        g_d = g_d + (-g_d.sum(dim=-1, keepdim=True)) / n
    dgamma = (dyf * (d * inv)).sum(dim=0)
    return g_d.to(x.dtype), dgamma, None if rms_only else dyf.sum(dim=0)


def nvu_layernorm_grad(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-5, segments: int = 16, rms_only: bool = False):
    """The backward of `nvu_layernorm(x, gamma, beta, eps, segments,
    rms_only)` for a 2-D x and dy of x's dtype: (dx, dgamma, dbeta), the
    last two float32 (dbeta None with rms_only)."""
    if x.ndim != 2 or dy.shape != x.shape:
        raise ValueError(f"nvu_layernorm_grad: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    rows, n = x.shape
    if gamma.numel() != n:
        raise ValueError(f"nvu_layernorm_grad: gamma does not match {n} columns")
    if x.device.type == "cpu":
        return nvu_layernorm_grad_plain(x, dy, gamma, eps, segments, rms_only)
    require_cuda(x, "nvu_layernorm_grad")
    if x.dtype not in KERNEL_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"nvu_layernorm_grad: x {x.dtype}, dy {dy.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    g = gamma.to(torch.float32).contiguous()
    if g.device != x.device:
        raise ValueError(f"nvu_layernorm_grad: operands on {x.device} and {g.device}")
    dx = torch.empty_like(x)
    dgamma = torch.empty(n, dtype=torch.float32, device=x.device)
    dbeta = None if rms_only else torch.empty(n, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dgamma.zero_(), None if rms_only else dbeta.zero_()
    lib = library()
    tab, stab = device_table("rsqrt", segments, x.device), slope_table("rsqrt", segments, x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    blocks = lib.npe_nvu_layernorm_grad_blocks(x.data_ptr(), dy.data_ptr(), g.data_ptr(),
                                               dx.data_ptr(), rows, n, bf16, int(rms_only),
                                               tab.shape[1] - 1)
    check(max(0, -blocks), "nvu_layernorm_grad")
    # each block's column sums: (rms_only ? 1 : 2) * n floats
    parts = torch.empty(blocks * (1 if rms_only else 2) * n, dtype=torch.float32,
                        device=x.device)
    err = lib.npe_nvu_layernorm_grad(
        x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        None if dbeta is None else dbeta.data_ptr(), parts.data_ptr(), blocks, rows, n, bf16,
        eps, int(rms_only), tab.data_ptr(), stab.data_ptr(), tab.shape[1] - 1,
        *table_ends("rsqrt", segments), stream_handle(x))
    check(err, "nvu_layernorm_grad")
    LAUNCHES["nvu_layernorm_grad"] += 1
    return dx, dgamma, dbeta

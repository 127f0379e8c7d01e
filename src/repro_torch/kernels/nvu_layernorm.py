"""NVU layernorm / rmsnorm kernel (counterpart of `repro/kernels/nvu_layernorm.py`).

`nvu_layernorm(x2d, ...)` launches `csrc/nvu_layernorm.cu` for a tensor on
the card and runs `nvu_layernorm_plain` for one on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.kernels.pwl_eval import KERNEL_DTYPES, device_table

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

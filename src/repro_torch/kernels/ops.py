"""Model-facing wrappers around the kernels (counterpart of `repro/kernels/ops.py`).

They take tensors of any leading shape, reshape them to the 2-D operands the
kernels take and back, and quantize the MMU's operands (activations per
tensor or per row, weights per column) outside the kernel, as the reference
does.
Flash attention takes (B, H, S, D) operands and the reference's blocking;
`dense_attention`, its dense mode, is re-exported here for the models.
Each kernel wrapper launches its kernel for a tensor on the card and runs
its plain version for a tensor on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.core.quant import quantize, quantize_columns
from repro_torch.kernels.flash_attention import dense_attention, dense_attention_plain
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_kernel
from repro_torch.kernels.nvu_layernorm import nvu_layernorm
from repro_torch.kernels.nvu_softmax import nvu_softmax
from repro_torch.kernels.pwl_eval import pwl_eval
from repro_torch.kernels.quant_matmul import quant_matmul


@contextlib.contextmanager
def plain_dense_attention():
    """Within: the models' attention (`dense_attention`) is its plain version
    (torch ops) on every device, which takes float32 k and v on the card,
    where the kernel takes a bf16 cache only: a float32 model on the card
    can then be held to a float32 implementation.  The other kernels stay."""
    global dense_attention
    saved, dense_attention = dense_attention, dense_attention_plain
    try:
        yield
    finally:
        dense_attention = saved


def pwl_activation(x: torch.Tensor, name: str, segments: int = 16) -> torch.Tensor:
    """Elementwise nonlinearity through the NVU: the PWL table `name` with
    its edge segments extrapolating (the guard segments of the saturating
    tables are flat, so for finite x that is their clamped evaluation), or,
    for relu2, whose table is unused, max and multiply."""
    if name == "relu2":
        return nvu.nvu_relu2(x, segments)
    return pwl_eval(x.reshape(-1, x.shape[-1]), name, segments).reshape(x.shape)


def pwl_exp(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """exp for x <= 0 through the NVU, floored at 0 as `core/nvu.nvu_exp` is
    (the table's least-squares values dip below 0 where exp is near 0)."""
    return pwl_activation(x, "exp", segments).clamp_min(0)


def pwl_rsqrt(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """1/sqrt(x) for x > 0 through the NVU, as `core/nvu.nvu_rsqrt`: the
    table on the power-of-4 mantissa, scaled by the exact power of two."""
    m, p = nvu._normalize_pow4(x)
    return torch.ldexp(pwl_activation(m, "rsqrt", segments), -p).to(x.dtype)


def quant_dense(x: torch.Tensor, w: torch.Tensor,
                act_axis: Optional[int] = None) -> torch.Tensor:
    """The 8-bit MMU: int8-quantize x per tensor (act_axis=0: each row of
    the flattened (M, K) x on its own) and w (K, N) per column (a chunk of
    columns at a time, `quantize_columns`), multiply into int32 and
    dequantize to x's dtype."""
    *lead, k = x.shape
    xq = quantize(x.reshape(-1, k), 8, axis=act_axis)
    wq = quantize_columns(w, 8)
    out = quant_matmul(xq.q, wq.q, xq.scale, wq.scale, out_dtype=x.dtype)
    return out.reshape(*lead, w.shape[1])


def softmax(x: torch.Tensor, segments: int = 16, causal: bool = False,
            scale: float = 1.0, out_dtype: Optional[torch.dtype] = None,
            limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NVU softmax of x * scale over the last axis, in out_dtype (default
    x's); `causal` masks each (q, n) matrix of the last two axes with the
    last query aligned to the last key.  `limit`, an integer tensor that
    broadcasts to x.shape[:-1], masks instead as `core/nvu.nvu_softmax`'s
    `where` does: each row sees the columns c < its limit.  A limit of one
    value for each (q, n) matrix (last axis 1) goes to the kernel as it is."""
    causal_rows = x.shape[-2] if causal else 0
    if limit is not None:
        lead = x.shape[:-1]
        if limit.ndim >= 1 and limit.shape[-1] == 1 and len(lead) >= 1:
            limit = limit.expand(*lead[:-1], 1)          # one a matrix
        else:
            limit = limit.expand(lead)                   # one a row
        limit = limit.reshape(-1)
    out = nvu_softmax(x.reshape(-1, x.shape[-1]), segments, causal_rows, scale, out_dtype,
                      limit)
    return out.reshape(x.shape)


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
              segments: int = 16, rms_only: bool = False) -> torch.Tensor:
    """NVU LayerNorm (or RMSNorm) over the last axis."""
    out = nvu_layernorm(x.reshape(-1, x.shape[-1]), gamma, beta, eps, segments,
                        rms_only)
    return out.reshape(x.shape)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
            segments: int = 16) -> torch.Tensor:
    """NVU RMSNorm over the last axis: the layernorm kernel without the mean
    and beta."""
    return layernorm(x, gamma, None, eps=eps, segments=segments, rms_only=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, use_pwl: bool = True,
                    segments: int = 16, block_q: int = 256, block_kv: int = 256,
                    kv_len: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flash attention with the NVU (PWL) softmax over (B, H, S, D) operands,
    blocked as the reference's `ops.flash_attention` blocks it: q blocks of
    min(block_q, Sq) rows, kv blocks of min(block_kv, Skv) keys."""
    sq, skv = q.shape[2], k.shape[2]
    return flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale,
                                  use_pwl=use_pwl, segments=segments,
                                  block_q=min(block_q, sq), block_kv=min(block_kv, skv),
                                  kv_len=kv_len, out_dtype=out_dtype)

"""Model-facing wrappers around the kernels (counterpart of `repro/kernels/ops.py`).

They take tensors of any leading shape, reshape them to the 2-D operands the
kernels take and back, and quantize the MMU's operands (activations per
tensor or per row, weights per column) outside the kernel, as the reference
does.
Flash attention takes (B, H, S, D) operands and the reference's blocking;
`dense_attention`, its dense mode, is the models' attention.
Each kernel wrapper launches its kernel for a tensor on the card and runs
its plain version for a tensor on the CPU.

The training path differentiates through these wrappers: `quant_dense`,
`softmax`, `layernorm`/`rmsnorm`, `pwl_activation`/`pwl_exp`/`pwl_rsqrt` and
`dense_attention` (where an operand takes a gradient) run as
`torch.autograd.Function`s whose forward is the kernel wrapper and whose
backward is the kernel's backward (`*_grad`: a hand-written kernel on
the card, explicit torch formulas on the CPU), which computes what jax.grad
of the reference's jnp code computes, its tie rules included (1/2 at a
tie of jnp.clip or jnp.maximum, an even split among tied maxima).  Under
`torch.no_grad()` they launch exactly what the wrappers launch.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.core.quant import quantize, quantize_columns, quantize_scale_grad
from repro_torch.kernels.flash_attention import dense_attention as dense_attention_kernel
from repro_torch.kernels.flash_attention import dense_attention_grad, dense_attention_plain
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_kernel
from repro_torch.kernels.nvu_layernorm import nvu_layernorm, nvu_layernorm_grad
from repro_torch.kernels.nvu_softmax import nvu_softmax, nvu_softmax_grad
from repro_torch.kernels.pwl_eval import max_factor, pwl_eval, pwl_eval_grad
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_scale_grad


class DenseAttentionFn(torch.autograd.Function):
    """flash attention's dense mode over the sequence itself (kv_len = Skv);
    backward `dense_attention_grad`, from the row statistics the forward
    wrote."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, stats = dense_attention_kernel(q, k, v, with_stats=True, **kw)
        ctx.save_for_backward(q, k, v, stats)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        kw = dict(ctx.kw)
        kv_len = kw.pop("kv_len", None)
        kw.pop("out_dtype", None)
        if kv_len not in (None, k.shape[2]):
            raise ValueError(f"dense_attention: no backward over {kv_len} of {k.shape[2]} keys "
                             "(a cache); it takes the sequence's own keys")
        return (*dense_attention_grad(q, k, v, do, stats=stats, **kw), None)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """flash attention's dense mode (`kernels/flash_attention.dense_attention`);
    with gradients on and an operand that takes one, through
    `DenseAttentionFn`, which launches the same kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return DenseAttentionFn.apply(q, k, v, kw)
    return dense_attention_kernel(q, k, v, **kw)


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


class PwlEvalFn(torch.autograd.Function):
    """`pwl_eval` of a 2-D x; backward `pwl_eval_grad` (`clamped`: the
    derivative of the table's clamped use)."""

    @staticmethod
    def forward(ctx, x, name, segments, clamped):
        ctx.save_for_backward(x)
        ctx.opts = (name, segments, clamped)
        return pwl_eval(x, name, segments)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return pwl_eval_grad(x, dy, *ctx.opts), None, None, None


class MaxFloorFn(torch.autograd.Function):
    """max(x, floor) with jax's gradient: 1/2 at the tie (torch's gives 1)."""

    @staticmethod
    def forward(ctx, x, floor):
        ctx.save_for_backward(x)
        ctx.floor = floor
        return x.clamp_min(floor)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return (dy.to(torch.float32) * max_factor(x, ctx.floor)).to(dy.dtype), None


def pwl_activation(x: torch.Tensor, name: str, segments: int = 16,
                   clamped: bool = False) -> torch.Tensor:
    """Elementwise nonlinearity through the NVU: the PWL table `name` with
    its edge segments extrapolating (the guard segments of the saturating
    tables are flat, so for finite x that is their clamped evaluation), or,
    for relu2, whose table is unused, max and multiply.  `clamped` takes
    the gradient of the table's clamped use (`nvu.pwl_eval_clamped`)."""
    if name == "relu2":
        return nvu.nvu_relu2(x, segments)
    return PwlEvalFn.apply(x.reshape(-1, x.shape[-1]), name, segments,
                           clamped).reshape(x.shape)


def pwl_exp(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """exp for x <= 0 through the NVU, floored at 0 as `core/nvu.nvu_exp` is
    (the table's least-squares values dip below 0 where exp is near 0)."""
    return MaxFloorFn.apply(pwl_activation(x, "exp", segments, clamped=True), 0.0)


def pwl_rsqrt(x: torch.Tensor, segments: int = 16) -> torch.Tensor:
    """1/sqrt(x) for x > 0 through the NVU, as `core/nvu.nvu_rsqrt`: the
    table on the power-of-4 mantissa, scaled by the exact power of two.
    The powers of two are float32 constants that multiply: the mantissa is
    x * 2^-e, whose gradient is jax's frexp's, and torch's ldexp and frexp
    give no usable gradient for integer exponents."""
    xf = x.to(torch.float32)
    _, e = torch.frexp(xf.detach())
    odd = (e % 2) != 0
    p = torch.div(torch.where(odd, e + 1, e), 2, rounding_mode="floor")
    one = torch.ones_like(xf.detach())
    m = xf * torch.ldexp(one, -e)                    # [0.5, 1)
    m = torch.where(odd, m * 0.5, m)                 # [0.25, 1)
    return (pwl_activation(m, "rsqrt", segments, clamped=True)
            * torch.ldexp(one, -p)).to(x.dtype)


class QuantDenseFn(torch.autograd.Function):
    """The 8-bit MMU on a 2-D x; backward through the two scales alone
    (`quant_matmul_scale_grad`, then `quantize_scale_grad` to the entries
    of x and of each column of w that set them)."""

    @staticmethod
    def forward(ctx, x, w, act_axis):
        xq = quantize(x, 8, axis=act_axis)
        wq = quantize_columns(w, 8)
        ctx.save_for_backward(x, w, xq.q, xq.scale, wq.q, wq.scale)
        ctx.act_axis = act_axis
        return quant_matmul(xq.q, wq.q, xq.scale, wq.scale, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, xq, xs, wq, ws = ctx.saved_tensors
        g_xs, g_ws = quant_matmul_scale_grad(xq, wq, xs, ws, dy)
        dx = quantize_scale_grad(x, g_xs, 8, ctx.act_axis) if ctx.needs_input_grad[0] else None
        dw = quantize_scale_grad(w, g_ws, 8, axis=1) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def quant_dense(x: torch.Tensor, w: torch.Tensor,
                act_axis: Optional[int] = None) -> torch.Tensor:
    """The 8-bit MMU: int8-quantize x per tensor (act_axis=0: each row of
    the flattened (M, K) x on its own) and w (K, N) per column (a chunk of
    columns at a time, `quantize_columns`), multiply into int32 and
    dequantize to x's dtype."""
    *lead, k = x.shape
    out = QuantDenseFn.apply(x.reshape(-1, k), w, act_axis)
    return out.reshape(*lead, w.shape[1])


class SoftmaxFn(torch.autograd.Function):
    """`nvu_softmax` of a 2-D x; backward `nvu_softmax_grad`."""

    @staticmethod
    def forward(ctx, x, segments, causal_rows, scale, out_dtype, limit):
        ctx.save_for_backward(x)
        ctx.opts = (segments, causal_rows, scale, limit)
        return nvu_softmax(x, segments, causal_rows, scale, out_dtype, limit)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        segments, causal_rows, scale, limit = ctx.opts
        dx = nvu_softmax_grad(x, dy, segments, causal_rows, scale, limit)
        return dx.to(x.dtype), None, None, None, None, None


class LayerNormFn(torch.autograd.Function):
    """`nvu_layernorm` of a 2-D x; backward `nvu_layernorm_grad`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, segments, rms_only):
        ctx.save_for_backward(x, gamma)
        ctx.opts = (eps, segments, rms_only)
        ctx.beta_dtype = None if beta is None else beta.dtype
        return nvu_layernorm(x, gamma, beta, eps, segments, rms_only)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = nvu_layernorm_grad(x, dy, gamma, *ctx.opts)
        dbeta = None if ctx.beta_dtype is None or dbeta is None else dbeta.to(ctx.beta_dtype)
        return dx, dgamma.to(gamma.dtype), dbeta, None, None, None


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
    out = SoftmaxFn.apply(x.reshape(-1, x.shape[-1]), segments, causal_rows, scale, out_dtype,
                          limit)
    return out.reshape(x.shape)


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
              segments: int = 16, rms_only: bool = False) -> torch.Tensor:
    """NVU LayerNorm (or RMSNorm) over the last axis."""
    out = LayerNormFn.apply(x.reshape(-1, x.shape[-1]), gamma, beta, eps, segments, rms_only)
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

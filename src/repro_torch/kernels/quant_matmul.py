"""The MMU kernel: int8 x int8 -> int32 with a dequantizing epilogue
(counterpart of `repro/kernels/quant_matmul.py`).

`quant_matmul(...)` launches `csrc/quant_matmul.cu` for tensors on the card
and runs `quant_matmul_plain` for tensors on the CPU.  At M <= 16 the kernel
may split K across blocks; their int32 partial sums meet in a zeroed
workspace that the wrapper keeps for each stream and the kernel leaves
zeroed again (one launch all the same).

`quant_matmul_scale_grad` is the MMU's backward on the training path: the
int8 product carries no gradient, so only the two scales do, and for them
it needs the int32 product itself, which it takes from one more launch of
the same kernel with unit scales and float32 out (the rounding of the
reference's `acc.astype(float32)`); the reductions are torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import nvu
from repro_torch.core.pwl import PWLTable, get_table
from repro_torch.core.quant import int_matmul
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.kernels.pwl_eval import device_table

OUT_DTYPES = (torch.float32, torch.bfloat16)

# (device index, stream handle) -> int32 zeros for the split-K partial sums
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(n: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < n:
        buf = _WORKSPACE[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _row_scales(x_scale: torch.Tensor, m: int) -> torch.Tensor:
    """x_scale as () for one value, or as (M, 1) for one value a row."""
    if x_scale.numel() == 1:
        return x_scale.reshape(())
    if x_scale.numel() != m:
        raise ValueError(f"quant_matmul: {x_scale.numel()} activation scales for M={m}")
    return x_scale.reshape(m, 1)


def quant_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                       w_scale: torch.Tensor, table: Optional[PWLTable] = None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """acc = xq @ wq exactly, then acc * (x_scale * w_scale[col]) as
    `core/quant.py`'s quant_dense orders it (x_scale one value, or one a
    row), then the optional PWL."""
    acc = int_matmul(xq, wq)
    xs = _row_scales(x_scale, xq.shape[0])
    out = acc.to(torch.float32) * (xs * w_scale.reshape(1, -1))
    if table is not None:
        out = nvu.pwl_eval(out, table)
    return out.to(out_dtype)


def quant_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, activation: Optional[str] = None,
                 segments: int = 16,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> (M,N) out_dtype, dequantized by x_scale
    (one value for the tensor, or M values, one a row) and the per-column
    w_scale (N values), with the PWL function `activation` fused into the
    epilogue if given."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"quant_matmul: shapes {tuple(xq.shape)} @ {tuple(wq.shape)}")
    m, k = xq.shape
    n = wq.shape[1]
    if x_scale.numel() not in (1, m) or w_scale.numel() != n:
        raise ValueError(f"quant_matmul: scales of {x_scale.numel()} and "
                         f"{w_scale.numel()} values for M={m}, N={n}")
    if xq.device.type == "cpu":
        table = get_table(activation, segments) if activation else None
        return quant_matmul_plain(xq, wq, x_scale, w_scale, table, out_dtype)
    require_cuda(xq, "quant_matmul")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"quant_matmul: int8 operands, got {xq.dtype}, {wq.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"quant_matmul: out_dtype {out_dtype} not in {OUT_DTYPES}")
    xq, wq = xq.contiguous(), wq.contiguous()
    xs = x_scale.to(torch.float32).contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    for t in (wq, xs, ws):
        if t.device != xq.device:
            raise ValueError(f"quant_matmul: operands on {xq.device} and {t.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    tab_ptr, segs = None, 0
    if activation:
        tab = device_table(activation, segments, xq.device)
        tab_ptr, segs = tab.data_ptr(), tab.shape[1] - 1
    lib = library()
    stream = stream_handle(xq)
    work_n = lib.npe_quant_matmul_workspace(m, n, k)
    work = _workspace(work_n, xq.device, stream).data_ptr() if work_n else None
    err = lib.npe_quant_matmul(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), int(xs.numel() != 1), ws.data_ptr(),
        out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16), tab_ptr,
        segs, work, stream)
    check(err, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return out


def scale_grads(acc: torch.Tensor, dy: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor):
    """(d/d x_scale, d/d w_scale) of out = acc * (x_scale * w_scale[col])
    against dy, each in its scale's shape: the product's gradient
    sum_m dy * acc, times the other scale, summed over what it broadcasts."""
    m = acc.shape[0]
    t = dy.to(torch.float32) * acc
    ws = w_scale.reshape(1, -1)
    if x_scale.numel() == 1:
        g_p = t.sum(dim=0, keepdim=True)
        return (g_p * ws).sum().reshape(x_scale.shape), (g_p * x_scale.reshape(())).reshape(
            w_scale.shape)
    xs = _row_scales(x_scale, m)
    return ((t * ws).sum(dim=1, keepdim=True).reshape(x_scale.shape),
            (t * xs).sum(dim=0, keepdim=True).reshape(w_scale.shape))


def quant_matmul_scale_grad_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                                  w_scale: torch.Tensor, dy: torch.Tensor):
    """`quant_matmul_scale_grad` with the int32 product by `int_matmul`."""
    return scale_grads(int_matmul(xq, wq).to(torch.float32), dy, x_scale, w_scale)


def quant_matmul_scale_grad(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                            w_scale: torch.Tensor, dy: torch.Tensor):
    """The backward of `quant_matmul(xq, wq, x_scale, w_scale)` (no
    activation): (d/d x_scale, d/d w_scale) against dy.  The int32 product
    comes from `quant_matmul` with unit scales and float32 out: the kernel
    on the card (counted as a launch of it), its plain version on the CPU."""
    ones_x = torch.ones(x_scale.numel(), dtype=torch.float32, device=xq.device)
    ones_w = torch.ones(w_scale.numel(), dtype=torch.float32, device=xq.device)
    acc = quant_matmul(xq, wq, ones_x, ones_w, out_dtype=torch.float32)
    return scale_grads(acc, dy, x_scale, w_scale)

"""NVU row-softmax kernel (counterpart of `repro/kernels/nvu_softmax.py`).

`nvu_softmax(x2d)` launches `csrc/nvu_softmax.cu` for a tensor on the card
and runs `nvu_softmax_plain` for one on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import nvu
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.kernels.pwl_eval import device_table

MAX_COLS = 1024      # a row lives in one warp's registers
NEG_BIG = -1e30


def causal_mask(rows: int, n: int, causal_rows: int, device) -> torch.Tensor:
    """(rows, n) bool: row r is query r % q of a (q, n) matrix, and it sees
    keys c <= r % q + (n - q), the last query aligned with the last key."""
    r = torch.arange(rows, device=device)[:, None] % causal_rows
    c = torch.arange(n, device=device)[None, :]
    return c <= r + (n - causal_rows)


def nvu_softmax_plain(x: torch.Tensor, segments: int = 16,
                      causal_rows: int = 0) -> torch.Tensor:
    """Max, clamp at -18, PWL exp floored at 0, sum, PWL reciprocal, as
    `core/nvu.py` and the reference oracle compute it."""
    xf = x.to(torch.float32)
    if causal_rows:
        xf = torch.where(causal_mask(*x.shape, causal_rows, x.device), xf, NEG_BIG)
    m = xf.amax(dim=-1, keepdim=True)
    e = nvu.nvu_exp(torch.clamp(xf - m, min=-18.0), segments)
    s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return (e * nvu.nvu_reciprocal(s, segments)).to(x.dtype)


def nvu_softmax(x: torch.Tensor, segments: int = 16,
                causal_rows: int = 0) -> torch.Tensor:
    """Softmax over the last dim of a 2-D f32 tensor.  With causal_rows=q > 0
    the rows are stacked (q, n) matrices, masked causally (see causal_mask)."""
    if x.ndim != 2:
        raise ValueError(f"nvu_softmax takes a 2-D tensor, got {tuple(x.shape)}")
    if causal_rows < 0:
        raise ValueError(f"nvu_softmax: causal_rows={causal_rows}")
    if x.device.type == "cpu":
        return nvu_softmax_plain(x, segments, causal_rows)
    require_cuda(x, "nvu_softmax")
    rows, n = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"nvu_softmax: float32 scores, got {x.dtype}")
    if n > MAX_COLS:
        raise ValueError(f"nvu_softmax: rows of {n} > {MAX_COLS} columns")
    x = x.contiguous()
    y = torch.empty_like(x)
    et = device_table("exp", segments, x.device)
    rt = device_table("recip", segments, x.device)
    err = library().npe_nvu_softmax(
        x.data_ptr(), y.data_ptr(), rows, n, causal_rows, et.data_ptr(),
        et.shape[1] - 1, rt.data_ptr(), rt.shape[1] - 1, stream_handle(x))
    check(err, "nvu_softmax")
    LAUNCHES["nvu_softmax"] += 1
    return y

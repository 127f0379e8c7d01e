"""NVU row-softmax kernel (counterpart of `repro/kernels/nvu_softmax.py`).

`nvu_softmax(x2d)` launches `csrc/nvu_softmax.cu` for a tensor on the card
and runs `nvu_softmax_plain` for one on the CPU.  `nvu_softmax_walk` is the
kernel's own arithmetic in torch ops, its order of addition included, which
the kernel's results equal bit for bit.

Two masks: `causal_rows` (the reference oracle's end-aligned causal mask, a
masked score set to -1e30) and `limit` (the npec executor's masked softmax,
`core/nvu.nvu_softmax` with `where`: row r sees columns c < limit of its
row; a masked column is out of the max and the sum and comes out 0).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.core.pwl import get_table
from repro_torch.kernels.pwl_eval import (clip_factor, device_table, max_factor,
                                          pwl_eval_walk, pwl_slope_plain, slope_table,
                                          table_ends)

MAX_COLS = 1024      # a row lives in one warp's registers
NEG_BIG = -1e30


def causal_mask(rows: int, n: int, causal_rows: int, device) -> torch.Tensor:
    """(rows, n) bool: row r is query r % q of a (q, n) matrix, and it sees
    keys c <= r % q + (n - q), the last query aligned with the last key."""
    r = torch.arange(rows, device=device)[:, None] % causal_rows
    c = torch.arange(n, device=device)[None, :]
    return c <= r + (n - causal_rows)


def _limit_rows(limit: torch.Tensor, rows: int) -> int:
    """Rows that share one limit: 1, or the q rows of a (q, n) matrix."""
    if limit.numel() == 0 or rows % limit.numel():
        raise ValueError(f"nvu_softmax: {limit.numel()} limits for {rows} rows")
    return rows // limit.numel()


def limit_mask(limit: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """(rows, n) bool: column c of row r is visible when c < the limit of
    its row (`limit` holds one a row, or one for each run of
    rows // limit.numel() rows)."""
    per_row = limit.reshape(-1).to(torch.int64).repeat_interleave(_limit_rows(limit, rows))
    return torch.arange(n, device=limit.device)[None, :] < per_row[:, None]


def nvu_softmax_plain(x: torch.Tensor, segments: int = 16, causal_rows: int = 0,
                      scale: float = 1.0, out_dtype: Optional[torch.dtype] = None,
                      limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x * scale, then max, clamp at -18, PWL exp floored at 0, sum, PWL
    reciprocal, as `core/nvu.py` and the reference oracle compute it; the
    result cast to out_dtype (default x's).  With `limit`, the masked
    softmax of `core/nvu.nvu_softmax(where=)`."""
    xf = x.to(torch.float32)
    if scale != 1.0:
        xf = xf * scale
    if limit is not None:
        where = limit_mask(limit.to(x.device), *x.shape)
        return nvu.nvu_softmax(xf, segments=segments, where=where).to(out_dtype or x.dtype)
    if causal_rows:
        xf = torch.where(causal_mask(*x.shape, causal_rows, x.device), xf, NEG_BIG)
    m = xf.amax(dim=-1, keepdim=True)
    e = nvu.nvu_exp(torch.clamp(xf - m, min=-18.0), segments)
    s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return (e * nvu.nvu_reciprocal(s, segments)).to(out_dtype or x.dtype)


def nvu_softmax_walk(x: torch.Tensor, segments: int = 16, causal_rows: int = 0,
                     scale: float = 1.0, out_dtype: Optional[torch.dtype] = None,
                     limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in float32 torch ops, each op rounding once as
    its `_rn` intrinsics do: x * scale, the mask, the max, the exp table's
    walk (`pwl_eval_walk`) clamped at -18 and floored at 0; the sum in the
    kernel's order (lane l adds columns l + 32j in ascending j, then the
    xor butterfly over the 32 lanes, which leaves every lane the same
    value); 1/sum by the recip table's walk on the mantissa in [0.5, 1) and
    the exponent put back as an exact power of two (`npe_recip_via_pwl`).
    With `limit`, a masked column is -inf before the max (a max of -inf
    becomes 0) and its exp is 0 before the sum."""
    rows, n = x.shape
    xf = x.to(torch.float32) * scale
    if causal_rows:
        xf = torch.where(causal_mask(rows, n, causal_rows, x.device), xf, NEG_BIG)
    where = None if limit is None else limit_mask(limit.to(x.device), rows, n)
    if where is not None:
        xf = torch.where(where, xf, -torch.inf)
    m = xf.amax(dim=-1, keepdim=True)
    if where is not None:
        m = torch.where(m == -torch.inf, 0.0, m)
    z = torch.clamp(xf - m, min=-18.0)
    e = torch.clamp(pwl_eval_walk(z, device_table("exp", segments, x.device)), min=0.0)
    if where is not None:
        e = torch.where(where, e, 0.0)
    lanes = -(-n // 32) * 32
    ev = torch.nn.functional.pad(e, (0, lanes - n)).view(rows, lanes // 32, 32)
    s = ev[:, 0]
    for j in range(1, ev.shape[1]):
        s = s + ev[:, j]
    idx = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    bits = torch.clamp(s[:, :1], min=1e-30).view(torch.int32)
    mant = ((bits & 0x007FFFFF) | (126 << 23)).view(torch.float32)
    r = pwl_eval_walk(mant, device_table("recip", segments, x.device))
    pow_field = torch.clamp(253 - ((bits >> 23) & 0xFF), 1, 254)
    inv = r * (pow_field << 23).view(torch.float32)
    return (e * inv).to(out_dtype or x.dtype)


def nvu_softmax(x: torch.Tensor, segments: int = 16, causal_rows: int = 0,
                scale: float = 1.0, out_dtype: Optional[torch.dtype] = None,
                limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the last dim of a 2-D f32 tensor, of x * scale (one f32
    multiply, before the max).  With causal_rows=q > 0 the rows are stacked
    (q, n) matrices, masked causally (see causal_mask).  With `limit`, an
    integer tensor of one value a row or one for each run of
    rows // limit.numel() rows, row r sees columns c < its limit (see
    limit_mask; the masked softmax of `core/nvu.nvu_softmax(where=)`).  The
    result is f32, or bf16 with out_dtype=torch.bfloat16: the f32
    probabilities rounded to nearest even, as `.to(torch.bfloat16)` rounds
    them.  Rows of more than MAX_COLS columns are refused on the card."""
    if x.ndim != 2:
        raise ValueError(f"nvu_softmax takes a 2-D tensor, got {tuple(x.shape)}")
    if causal_rows < 0:
        raise ValueError(f"nvu_softmax: causal_rows={causal_rows}")
    if limit is not None:
        if causal_rows:
            raise ValueError("nvu_softmax: causal_rows and limit together")
        limit_rows = _limit_rows(limit, x.shape[0])
    if x.device.type == "cpu":
        return nvu_softmax_plain(x, segments, causal_rows, scale, out_dtype, limit)
    require_cuda(x, "nvu_softmax")
    rows, n = x.shape
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.float32:
        raise TypeError(f"nvu_softmax: float32 scores, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nvu_softmax: output {out_dtype}, not float32 or bfloat16")
    if n > MAX_COLS:
        raise ValueError(f"nvu_softmax: rows of {n} > {MAX_COLS} columns")
    x = x.contiguous()
    lim_ptr = None
    if limit is not None:
        if limit.device != x.device:
            raise ValueError(f"nvu_softmax: limit on {limit.device}, scores on {x.device}")
        limit = limit.to(torch.int32).contiguous()
        lim_ptr = limit.data_ptr()
    y = torch.empty(rows, n, dtype=out_dtype, device=x.device)
    et = device_table("exp", segments, x.device)
    rt = device_table("recip", segments, x.device)
    err = library().npe_nvu_softmax(
        x.data_ptr(), y.data_ptr(), rows, n, causal_rows, lim_ptr,
        limit_rows if limit is not None else 1, float(scale),
        int(out_dtype == torch.bfloat16), et.data_ptr(), et.shape[1] - 1,
        rt.data_ptr(), rt.shape[1] - 1, stream_handle(x))
    check(err, "nvu_softmax")
    LAUNCHES["nvu_softmax"] += 1
    return y


def visible_mask(rows: int, n: int, causal_rows: int = 0,
                 limit: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """(rows, n) bool: the columns each row's softmax takes part in."""
    if limit is not None:
        return limit_mask(limit.to(device), rows, n)
    if causal_rows:
        return causal_mask(rows, n, causal_rows, device)
    return torch.ones(rows, n, dtype=torch.bool, device=device)


def softmax_where_grad_plain(s: torch.Tensor, dy: torch.Tensor, vis: torch.Tensor,
                             segments: int = 16, row_max: Optional[torch.Tensor] = None,
                             row_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d/ds (float32) of `core/nvu.nvu_softmax(s, where=vis)` over the last
    axis of float32 scores s against dy, chain rule for chain rule through
    the reference's jnp code: the PWL reciprocal's slope at the mantissa of
    max(sum, 1e-30) times 2^-e twice (ldexp, frexp), 1/2 where the sum ties
    1e-30; each exp's segment slope, 1/2 where the PWL ties 0 (jnp.maximum)
    or an end of its clip; the row max's term, split evenly among tied
    maxima.  A masked column, and every column of a row with none visible,
    gets 0.  `row_max` and `row_inv` (keepdim shapes), when given, are the
    forward's row max and reciprocal of the sum (the forward's statistics:
    the same values as those computed here from s, so the same bits)."""
    xs = torch.where(vis, s, -torch.inf)
    m = xs.amax(dim=-1, keepdim=True)
    none = m == -torch.inf
    if row_max is not None:
        m = torch.where(none, m, row_max)
    z = xs - torch.where(none, 0.0, m)
    et, rt = get_table("exp", segments), get_table("recip", segments)
    lo, hi = table_ends("exp", segments)
    zc = torch.clamp(z, lo, hi)
    er = nvu.pwl_eval(zc, et)
    e = torch.where(vis, torch.clamp(er, min=0.0), 0.0)
    total = e.sum(dim=-1, keepdim=True)
    sc = torch.clamp(total, min=1e-30)
    inv = nvu.nvu_reciprocal(sc, segments) if row_inv is None else row_inv
    dyf = dy.to(torch.float32)
    g_inv = (dyf * e).sum(dim=-1, keepdim=True)
    mant, ex = torch.frexp(sc)
    rlo, rhi = table_ends("recip", segments)
    g_s = (torch.ldexp(g_inv, -ex) * pwl_slope_plain(torch.clamp(mant, rlo, rhi), rt)
           * clip_factor(mant, rlo, rhi))
    g_s = torch.ldexp(g_s, -ex) * max_factor(total, 1e-30)
    g_z = (dyf * inv + g_s) * max_factor(er, 0.0) * pwl_slope_plain(zc, et) * clip_factor(z, lo, hi)
    g_z = torch.where(vis, g_z, 0.0)
    ties = vis & (z == 0)
    share = -g_z.sum(dim=-1, keepdim=True) / ties.sum(dim=-1, keepdim=True)
    g = torch.where(ties, g_z + share, g_z)
    return torch.where(vis & ~none, g, 0.0)


def nvu_softmax_grad_plain(x: torch.Tensor, dy: torch.Tensor, segments: int = 16,
                           causal_rows: int = 0, scale: float = 1.0,
                           limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d/dx (float32) of nvu_softmax(x, ...) against dy: the masked softmax's
    gradient (`softmax_where_grad_plain`) at x * scale, times scale."""
    rows, n = x.shape
    vis = visible_mask(rows, n, causal_rows, limit, x.device)
    return softmax_where_grad_plain(x.to(torch.float32) * scale, dy, vis, segments) * scale


def nvu_softmax_grad(x: torch.Tensor, dy: torch.Tensor, segments: int = 16,
                     causal_rows: int = 0, scale: float = 1.0,
                     limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward of `nvu_softmax(x, segments, causal_rows, scale, ...,
    limit)` against dy (the output's dtype, f32 or bf16): dx in float32."""
    if x.ndim != 2 or dy.shape != x.shape:
        raise ValueError(f"nvu_softmax_grad: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    if limit is not None:
        limit_rows = _limit_rows(limit, x.shape[0])
    if x.device.type == "cpu":
        return nvu_softmax_grad_plain(x, dy, segments, causal_rows, scale, limit)
    require_cuda(x, "nvu_softmax_grad")
    rows, n = x.shape
    if x.dtype != torch.float32 or dy.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nvu_softmax_grad: x {x.dtype}, dy {dy.dtype}")
    if n > MAX_COLS:
        raise ValueError(f"nvu_softmax_grad: rows of {n} > {MAX_COLS} columns")
    x, dy = x.contiguous(), dy.contiguous()
    lim_ptr = None
    if limit is not None:
        limit = limit.to(device=x.device, dtype=torch.int32).contiguous()
        lim_ptr = limit.data_ptr()
    dx = torch.empty(rows, n, dtype=torch.float32, device=x.device)
    et, es = device_table("exp", segments, x.device), slope_table("exp", segments, x.device)
    rt, rs = device_table("recip", segments, x.device), slope_table("recip", segments, x.device)
    err = library().npe_nvu_softmax_grad(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), rows, n, causal_rows, lim_ptr,
        limit_rows if limit is not None else 1, float(scale), int(dy.dtype == torch.bfloat16),
        et.data_ptr(), es.data_ptr(), et.shape[1] - 1, *table_ends("exp", segments),
        rt.data_ptr(), rs.data_ptr(), rt.shape[1] - 1, *table_ends("recip", segments),
        stream_handle(x))
    check(err, "nvu_softmax_grad")
    LAUNCHES["nvu_softmax_grad"] += 1
    return dx

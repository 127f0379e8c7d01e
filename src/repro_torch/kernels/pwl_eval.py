"""Elementwise PWL kernel (counterpart of `repro/kernels/pwl_eval.py`).

`pwl_eval(x, name)` launches `csrc/pwl_eval.cu` for a tensor on the card and
runs `pwl_eval_plain` for one on the CPU.  `pwl_eval_walk` is the kernel's
own arithmetic in torch ops, which its float32 results equal bit for bit.

`pwl_eval_grad(x, dy, name)` is the derivative mode, the backward of the
training path: dy times the slope of x's segment, as jax.grad of the
reference's `slope[seg] * x + icept[seg]` gives it (with `clamped`, of
its `pwl_eval_clamped`: the slope at clip(x), 1/2 at an end, 0 past it).
It launches the same source's `pwl_grad_kernel` on the card and runs
`pwl_eval_grad_plain`, explicit torch formulas, on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import nvu
from repro_torch.core.pwl import PWLTable, get_table
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle

MAX_TABLE_COLS = 128   # NPE_MAX_TABLE_COLS in csrc/pwl.cuh
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def pack_table(table: PWLTable) -> np.ndarray:
    """Pack a PWLTable into the (3, S+1) prefix-delta form the kernels read:
    row 0 the interior knots, rows 1 and 2 slope_0 / icept_0 followed by
    their deltas."""
    s = int(table.num_segments)
    z = np.zeros((1,), np.float32)
    knots = np.concatenate([z, np.asarray(table.knots)[1:-1], z])
    dslopes = np.concatenate([np.asarray(table.slopes)[:1],
                              np.diff(np.asarray(table.slopes)), z])
    dicepts = np.concatenate([np.asarray(table.intercepts)[:1],
                              np.diff(np.asarray(table.intercepts)), z])
    return np.stack([knots[:s + 1], dslopes[:s + 1], dicepts[:s + 1]])


@functools.lru_cache(maxsize=None)
def device_table(name: str, segments: int, device: torch.device) -> torch.Tensor:
    """The packed table of `name` on `device`, copied there once."""
    packed = pack_table(get_table(name, segments))
    if packed.shape[1] > MAX_TABLE_COLS:
        raise ValueError(f"{name} table has {packed.shape[1]} columns; "
                         f"the kernels take at most {MAX_TABLE_COLS}")
    return torch.as_tensor(np.ascontiguousarray(packed), device=device)


@functools.lru_cache(maxsize=None)
def slope_table(name: str, segments: int, device: torch.device) -> torch.Tensor:
    """The (2, S+1) slope table the backward kernels read (csrc/pwl.cuh):
    the packed table's knot row, then the table's S slopes and a 0."""
    table = get_table(name, segments)
    packed = pack_table(table)
    slopes = np.concatenate([np.asarray(table.slopes, np.float32), np.zeros(1, np.float32)])
    return torch.as_tensor(np.ascontiguousarray(np.stack([packed[0], slopes])), device=device)


def table_ends(name: str, segments: int = 16):
    """(first knot, last knot) of `name`'s table as Python floats: the clip
    interval of its clamped use."""
    knots = get_table(name, segments).knots
    return float(knots[0]), float(knots[-1])


def pwl_slope_plain(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """The slope of each float32 x's segment (the count of interior knots
    <= x, as `core/nvu.pwl_eval` finds it)."""
    knots = torch.as_tensor(np.asarray(table.knots), device=x.device)
    slopes = torch.as_tensor(np.asarray(table.slopes), device=x.device)
    seg = (x[..., None] >= knots[1:-1]).sum(-1)
    return slopes[seg]


def pwl_eval_grad_plain(x: torch.Tensor, dy: torch.Tensor, table: PWLTable,
                        clamped: bool = False) -> torch.Tensor:
    """dx = dy * slope(seg(x)) in float32, rounded to x's dtype; with
    `clamped`, at clip(x) and times 1/2 at an end of the table, 0 past it."""
    xf = x.to(torch.float32)
    f = 1.0
    if clamped:
        lo, hi = float(table.knots[0]), float(table.knots[-1])
        f = clip_factor(xf, lo, hi)
        xf = torch.clamp(xf, lo, hi)
    return (dy.to(torch.float32) * pwl_slope_plain(xf, table) * f).to(x.dtype)


def clip_factor(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """What jax.grad multiplies by through jnp.clip(x, lo, hi): 1 inside,
    1/2 at an end (a tied max or min splits evenly), 0 outside."""
    inside = ((x > lo) & (x < hi)).to(torch.float32)
    return inside + 0.5 * ((x == lo) | (x == hi)).to(torch.float32)


def max_factor(v: torch.Tensor, floor: float) -> torch.Tensor:
    """What jax.grad multiplies by through jnp.maximum(v, floor): 1 above,
    1/2 at the tie, 0 below."""
    return (v > floor).to(torch.float32) + 0.5 * (v == floor).to(torch.float32)


def pwl_eval_plain(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """The same function with torch ops, as `core/nvu.py` computes it."""
    return nvu.pwl_eval(x, table)


def pwl_eval_walk(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The prefix-delta walk of `npe_pwl` (csrc/pwl.cuh) in float32 torch ops
    over a packed table: start from slope_0 / icept_0, add each delta whose
    knot x reaches, in knot order, then slope * x + icept.  Each eager op
    rounds to nearest once (no multiply-add is fused), as the kernel's `_rn`
    intrinsics do.  A bf16 result of the kernel is this value cast to bf16."""
    xf = x.to(torch.float32)
    tab = packed.to(device=x.device, dtype=torch.float32)
    slope = tab[1, 0].expand_as(xf).clone()
    icept = tab[2, 0].expand_as(xf).clone()
    for i in range(1, tab.shape[1] - 1):
        hit = xf >= tab[0, i]
        slope = torch.where(hit, slope + tab[1, i], slope)
        icept = torch.where(hit, icept + tab[2, i], icept)
    return slope * xf + icept


def pwl_eval(x: torch.Tensor, name: str, segments: int = 16) -> torch.Tensor:
    """PWL-evaluate `name` elementwise over a 2-D f32 or bf16 tensor; the
    result has x's dtype."""
    if x.ndim != 2:
        raise ValueError(f"pwl_eval takes a 2-D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pwl_eval_plain(x, get_table(name, segments))
    require_cuda(x, "pwl_eval")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"pwl_eval: dtype {x.dtype} not in {KERNEL_DTYPES}")
    x = x.contiguous()
    y = torch.empty_like(x)
    tab = device_table(name, segments, x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    err = library().npe_pwl_eval(x.data_ptr(), y.data_ptr(), x.numel(), bf16,
                                 bf16, tab.data_ptr(), tab.shape[1] - 1,
                                 stream_handle(x))
    check(err, "pwl_eval")
    LAUNCHES["pwl_eval"] += 1
    return y


def pwl_eval_grad(x: torch.Tensor, dy: torch.Tensor, name: str, segments: int = 16,
                  clamped: bool = False) -> torch.Tensor:
    """The backward of `pwl_eval(x, name)` (clamped: of its clamped use)
    for a 2-D x and a dy of x's shape and dtype; the result has x's dtype."""
    if x.ndim != 2 or dy.shape != x.shape:
        raise ValueError(f"pwl_eval_grad: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return pwl_eval_grad_plain(x, dy, get_table(name, segments), clamped)
    require_cuda(x, "pwl_eval_grad")
    if x.dtype not in KERNEL_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"pwl_eval_grad: x {x.dtype}, dy {dy.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    tab = slope_table(name, segments, x.device)
    lo, hi = table_ends(name, segments)
    err = library().npe_pwl_eval_grad(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel(),
                                      int(x.dtype == torch.bfloat16), tab.data_ptr(),
                                      tab.shape[1] - 1, int(clamped), lo, hi, stream_handle(x))
    check(err, "pwl_eval_grad")
    LAUNCHES["pwl_eval_grad"] += 1
    return dx

"""Selective SSM (Mamba-style) head (counterpart of `repro/models/ssm.py`),
used by the Hymba hybrid.

Mamba-1 structure: a depthwise causal conv, data-dependent (dt, B, C)
selectivity, the diagonal state transition exp(dt * A), a gated output.  The
state is (B, d_inner, N) in float32, N = cfg.ssm.state_dim.

NPE mode: in_proj, x_proj and out_proj go through the MMU; softplus (dt),
silu (the conv's activation and the gate) and exp(dt * A) (floored at 0,
as `core/nvu.nvu_exp`) through the PWL kernel.  `dt_in @ dt_proj_w` stays
`torch.matmul`, as the reference computes it outside `cm.dense`.  The scan
is a Python loop over time, as the reference's `lax.scan` step (its chunked
checkpointing serves only training memory and is not ported).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import param

ONES = ("a_log", "d_skip")            # initialised to one; other vectors to zero
SCALES = {"conv_w": 0.5, "dt_proj_w": 0.1}


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, state dim N, dt rank)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(1, cfg.d_model // 16)
    return d_inner, cfg.ssm.state_dim, dt_rank


class Mamba(nn.Module):
    """One layer's SSM head weights (the reference's `blocks.ssm`)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D = cfg.d_model
        di, N, dtr = dims(cfg)
        K = cfg.ssm.conv_dim
        self.in_proj = param(D, 2 * di, **kw)
        self.conv_w, self.conv_b = param(K, di, **kw), param(di, **kw)
        self.x_proj = param(di, dtr + 2 * N, **kw)
        self.dt_proj_w, self.dt_proj_b = param(dtr, di, **kw), param(di, **kw)
        self.a_log, self.d_skip = param(di, N, **kw), param(di, **kw)
        self.out_proj = param(di, D, **kw)


def _conv_causal(x, w, b, x_prev):
    """Depthwise causal conv.  x: (B, T, C), w: (K, C), x_prev: (B, K-1, C).
    Returns (out, the last K-1 inputs)."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.cat([x_prev.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + t] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):]


def apply_layer(cfg: ModelConfig, p: Mamba, x, state, conv_state):
    """x: (B, T, D); state: (B, di, N) float32; conv_state: (B, K-1, di).
    Returns (out (B, T, D), new state, new conv state)."""
    t = x.shape[1]
    di, N, dtr = dims(cfg)
    xs, z = cm.dense(cfg, x, p.in_proj).split(di, dim=-1)
    xs, new_conv = _conv_causal(xs, p.conv_w, p.conv_b, conv_state)
    xs = cm.nonlinearity(cfg, "silu", xs, F.silu)
    dt_in, bm, cmat = cm.dense(cfg, xs, p.x_proj).split([dtr, N, N], dim=-1)
    dt = cm.nonlinearity(cfg, "softplus", dt_in @ p.dt_proj_w.to(x.dtype) + p.dt_proj_b,
                         F.softplus)                          # (B, T, di)
    a = -torch.exp(p.a_log.to(torch.float32))                # (di, N), negative
    dtx = (dt * xs).to(torch.float32)                         # (B, T, di)
    dt, bm, cmat = dt.to(torch.float32), bm.to(torch.float32), cmat.to(torch.float32)
    ys = []
    for i in range(t):
        da = cm.nonlinearity(cfg, "exp", dt[:, i, :, None] * a, torch.exp)   # (B, di, N)
        state = da * state + dtx[:, i, :, None] * bm[:, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", state, cmat[:, i]))
    y = torch.stack(ys, dim=1).to(x.dtype)                    # (B, T, di)
    y = y + xs * p.d_skip
    y = y * cm.nonlinearity(cfg, "silu", z, F.silu)
    return cm.dense(cfg, y, p.out_proj), state, new_conv


def state_specs(cfg: ModelConfig, L: int, batch: int) -> Dict[str, Tuple]:
    """The float32 scan state and the conv's last K-1 inputs (cfg.dtype) of
    L layers, keyed as the reference's tree."""
    di, N, _ = dims(cfg)
    K = cfg.ssm.conv_dim
    return {"ssm": ((L, batch, di, N), torch.float32),
            "conv": ((L, batch, K - 1, di), getattr(torch, cfg.dtype))}

"""AdamW, its learning-rate schedules and global-norm clipping (counterpart
of `repro/optim/adamw.py`).

Every quantity is a float32 tensor, as in the reference: the step, the
warmup and cosine terms and `b1 ** step` included (Python float64 scalars
would round otherwise).  Moments are kept in `moment_dtype`; the gradients
are clipped by their global norm and the raw norm is reported.  Parameters,
gradients and moments are trees of tensors (`repro_torch.tree`), such as a
model's `{name: parameter}`; `update` returns new tensors and changes
none of its inputs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.config import OptimizerConfig

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    m: Any                     # tree like params
    v: Any


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a tensor or an int): linear warmup over
    `warmup_steps`, then cosine (or linear) decay to 0 at `decay_steps`,
    or constant; float32 throughout."""
    step = torch.as_tensor(step)
    dev = step.device
    s = step.to(F32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), dev), _f32(1.0, dev))
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((s - _f32(cfg.warmup_steps, dev))
                    / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), dev), 0, 1)
    if cfg.schedule == "linear":
        return cfg.lr * warm * (1 - t)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(_f32(math.pi, dev) * t))   # cosine


def init(cfg: OptimizerConfig, params) -> OptState:
    mdt = getattr(torch, cfg.moment_dtype)
    first = T.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=first.device),
                    T.tree_map(zeros, params), T.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in T.leaves(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, state: OptState,
           params) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm"})."""
    step = state.step + 1
    dev = step.device
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.minimum(_f32(1.0, dev), cfg.grad_clip / torch.maximum(gnorm, _f32(1e-9, dev)))
             if cfg.grad_clip > 0 else 1.0)
    mdt = getattr(torch, cfg.moment_dtype)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(F32)
    c1 = 1 - _f32(b1, dev) ** sf
    c2 = 1 - _f32(b2, dev) ** sf

    def upd(g, m, v, p):
        g = g.to(F32) * scale
        m1 = b1 * m.to(F32) + (1 - b1) * g
        v1 = b2 * v.to(F32) + (1 - b2) * g * g
        mhat = m1 / c1
        vhat = v1 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m1.to(mdt), v1.to(mdt)

    out = [upd(g, m, v, p) for g, m, v, p in
           zip(T.leaves(grads), T.leaves(state.m), T.leaves(state.v), T.leaves(params))]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), {"lr": lr, "grad_norm": gnorm}

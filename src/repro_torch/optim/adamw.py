"""AdamW, its learning-rate schedules and global-norm clipping (counterpart
of `repro/optim/adamw.py`).

Every quantity is a float32 tensor, as in the reference: the step, the
warmup and cosine terms and `b1 ** step` included (Python float64 scalars
would round otherwise).  Moments are kept in `moment_dtype`; the gradients
are clipped by their global norm and the raw norm is reported.  Parameters,
gradients and moments are trees of tensors (`repro_torch.tree`), such as a
model's `{name: parameter}`.  `update` writes the new parameters and
moments into the given ones, a leaf at a time, as the reference's trainer
donates its parameters and state to the step: beside the gradients, the
step holds one copy of the parameters and of each moment and one leaf's
temporaries, not a second copy of the whole state (StarCoder2-3B's 12.7 GB
of masters and 25.4 GB of moments would not fit twice on an 80 GB card).
The values are those of the out-of-place update bit for bit: the same
float32 expressions, each rounded to its leaf's dtype on the write.
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
    """One AdamW step written into `params` and `state`'s moments in place:
    (params, the new state, {"lr", "grad_norm"}), the trees those given."""
    step = state.step + 1
    dev = step.device
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.minimum(_f32(1.0, dev), cfg.grad_clip / torch.maximum(gnorm, _f32(1e-9, dev)))
             if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(F32)
    c1 = 1 - _f32(b1, dev) ** sf
    c2 = 1 - _f32(b2, dev) ** sf
    for g, m, v, p in zip(T.leaves(grads), T.leaves(state.m), T.leaves(state.v),
                          T.leaves(params)):
        g = g.to(F32) * scale
        m1 = b1 * m.to(F32) + (1 - b1) * g
        m.copy_(m1)                              # rounds to the moment's dtype
        v1 = b2 * v.to(F32) + (1 - b2) * g * g
        v.copy_(v1)
        delta = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps) + cfg.weight_decay * p.to(F32)
        del m1, v1, g
        p.copy_(p.to(F32) - lr * delta)          # rounds to the parameter's dtype
    return params, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}

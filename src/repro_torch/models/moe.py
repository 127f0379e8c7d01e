"""Mixture-of-Experts block (counterpart of `repro/models/moe.py`).

GShard top-k routing with a capacity per sequence, as the reference does it:
  1. router logits, a float32 product, then the router function: softmax
     (the NVU softmax kernel in NPE mode) or sigmoid (llama4; the PWL table
     through the `pwl_eval` kernel in NPE mode), float32 in and out;
  2. the top k experts of each token, the lower index first among equal
     probabilities as `jax.lax.top_k` orders them; a softmax router's k > 1
     gates renormalized to sum to one;
  3. each (token, choice) takes the next slot of its expert in token order;
     slots at or past the capacity C = max(1, int(S * k / E * factor)) are
     dropped (the token gets nothing from that expert);
  4. three expert products in x's dtype over the dispatched buffer (each
     expert's B x C slots), the activation between them (the NVU's in NPE
     mode), as the reference's einsums compute them outside any Pallas
     kernel;
  5. each kept (token, choice) takes gate * its expert's output, the gate
     cast to x's dtype first, and the k terms are summed in x's dtype;
  6. the shared expert (llama4) through `common.dense`, the MMU in NPE mode.

The reference dispatches and combines by one-hot products (`dispatch_mask`,
a (B, S*k, E, C) tensor of zeros and ones); here the buffer is filled by an
index scatter and read back by an index gather.  Every dispatch and combine
term of the reference has exactly one nonzero product, so the two give the
same bits; `dispatch_mask` is kept as the reference's function for the
tests and the npec executor.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.common import param


def specs(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one MoE layer's weights, keyed as the reference's tree
    (`moe.specs` without its leading layer axis): the router (D, E), the
    expert stacks wg, wu (E, D, F) and wd (E, F, D), and with a shared
    expert `shared.wg`, `shared.wu` (D, F) and `shared.wd` (F, D)."""
    m = cfg.moe
    D, Fd, E = cfg.d_model, cfg.d_ff, m.num_experts
    out = {"router": (D, E), "wg": (E, D, Fd), "wu": (E, D, Fd), "wd": (E, Fd, D)}
    if m.shared_expert:
        out.update({"shared.wg": (D, Fd), "shared.wu": (D, Fd), "shared.wd": (Fd, D)})
    return out


class SharedExpert(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.wg, self.wu, self.wd = param(D, Fd, **kw), param(D, Fd, **kw), param(Fd, D, **kw)


class MoE(nn.Module):
    """One MoE layer's weights, shaped by `specs`."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        for name, shape in specs(cfg).items():
            if "." not in name:
                setattr(self, name, param(*shape, **kw))
        if cfg.moe.shared_expert:
            self.shared = SharedExpert(cfg, **kw)


def dispatch_mask(expert_ids_flat: torch.Tensor, num_experts: int,
                  capacity: int) -> torch.Tensor:
    """The reference's GShard dispatch tensor (b, t, E, C) in float32 from
    flattened expert ids (b, t): a one-hot cumsum gives each assignment its
    position in its expert; positions at or past C dispatch to nothing."""
    b, t = expert_ids_flat.shape
    oh_e = F.one_hot(expert_ids_flat.long(), num_experts).to(torch.float32)
    pos = ((torch.cumsum(oh_e, dim=1) - oh_e) * oh_e).sum(-1)
    slot = torch.where(pos < capacity, pos, torch.full_like(pos, capacity)).long()
    oh_c = F.one_hot(slot, capacity + 1).to(torch.float32)[..., :capacity]
    return oh_e[..., None] * oh_c.reshape(b, t, 1, capacity)


def dispatch_slots(expert_ids_flat: torch.Tensor, num_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, kept), each (b, t): the position of each assignment in its
    expert (the count of earlier assignments of the same sequence to it,
    an integer cumsum) and whether it is below the capacity; `dispatch_mask`
    is one at [b, t, id, slot] for the kept ones and zero elsewhere."""
    oh = F.one_hot(expert_ids_flat.long(), num_experts)
    before = torch.cumsum(oh, dim=1) - oh
    slot = before.gather(-1, expert_ids_flat.long()[..., None])[..., 0]
    return slot, slot < capacity


def renormalize_gates(gate_vals: torch.Tensor) -> torch.Tensor:
    """A softmax router's top-k gates renormalized over the selected k."""
    return gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis in descending
    order, the lower index first among equal values, as `jax.lax.top_k`
    gives them (`torch.topk` promises no order among ties): a stable
    descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32, whatever the process's matmul precision: on
    the card TF32 would move router logits and flip experts."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        torch.set_float32_matmul_precision(prev)


def _router_probs(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The router function on float32 logits (b, s, E), float32 out."""
    seg = cfg.npe_pwl_segments
    if cfg.moe.router_act == "sigmoid":
        return ops.pwl_activation(logits, "sigmoid", seg) if cfg.npe_pwl \
            else torch.sigmoid(logits)
    return ops.softmax(logits, segments=seg) if cfg.npe_pwl else torch.softmax(logits, -1)


class Routing(NamedTuple):
    gates: torch.Tensor       # (b, s*k) float32: each choice's gate
    expert_ids: torch.Tensor  # (b, s*k) long, token-major, choices in rank order
    slot: torch.Tensor        # (b, s*k) long: the position in its expert
    kept: torch.Tensor        # (b, s*k) bool: slot < capacity
    capacity: int


def route(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> Routing:
    """Steps 1-3 of the module's docstring for x (b, s, D)."""
    m = cfg.moe
    b, s, _ = x.shape
    E, k = m.num_experts, m.top_k
    probs = _router_probs(cfg, _f32_product(x, p.router))
    gate_vals, expert_ids = top_k(probs, k)
    if m.router_act == "softmax" and k > 1:
        gate_vals = renormalize_gates(gate_vals)
    cap = max(1, int(s * k / E * m.capacity_factor))
    ids = expert_ids.reshape(b, s * k)
    slot, kept = dispatch_slots(ids, E, cap)
    return Routing(gate_vals.reshape(b, s * k), ids, slot, kept, cap)


class ForcedRouting:
    """Within: each call of `route` (one a MoE layer, in layer order) takes
    the expert ids `ids[i]` (k a token, e.g. the npec executor's topk
    output) in place of its own top-k; its gates are its own router
    probabilities at those ids (renormalized as `route` does), its slots
    and drops `dispatch_slots` of them.  Records each call's input and
    routing (`calls`), and where its own top-k differs: the count
    (`differ`) and the largest probability gap between its own and the
    forced choice at the same rank (`gap`).  Two implementations that sum
    router products in other orders can choose other experts on the last
    bit of a probability; forced to the same ids, their outputs compare."""

    def __init__(self, ids):
        self.ids, self.calls, self.differ, self.gap = ids, [], 0, 0.0

    def __enter__(self):
        self.route = own_route = route

        def forced(cfg, p, x):
            own = own_route(cfg, p, x)
            m = cfg.moe
            b, s, _ = x.shape
            ids = self.ids[len(self.calls)].to(device=x.device, dtype=torch.long)
            ids = ids.reshape(b, s, m.top_k)
            probs = _router_probs(cfg, _f32_product(x, p.router))
            gates = probs.gather(-1, ids)
            if m.router_act == "softmax" and m.top_k > 1:
                gates = renormalize_gates(gates)
            flat = ids.reshape(b, s * m.top_k)
            slot, kept = dispatch_slots(flat, m.num_experts, own.capacity)
            mine = own.expert_ids.reshape(b, s, m.top_k)
            diff = mine != ids
            self.differ += int(diff.sum())
            if diff.any():
                gap = (probs.gather(-1, mine) - probs.gather(-1, ids)).detach().abs()[diff]
                self.gap = max(self.gap, float(gap.max()))
            r = Routing(gates.reshape(b, -1), flat, slot, kept, own.capacity)
            self.calls.append((x.detach().clone(), r))
            return r

        globals()["route"] = forced
        return self

    def __exit__(self, *exc):
        globals()["route"] = self.route


def apply(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); differentiable (the serving callers run it
    under `torch.no_grad()`).  The gradient reaches the router through the
    gates of the kept choices alone: `top_k`'s sort, `renormalize_gates`
    and the router function (the NVU softmax's backward kernel, or the
    sigmoid's table slope), as jax.grad of the reference's one-hot
    dispatch and combine gives it; a choice dropped by capacity passes
    none, to its gate or to its token."""
    m = cfg.moe
    b, s, D = x.shape
    E, k = m.num_experts, m.top_k
    r = route(cfg, p, x)
    C = r.capacity
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    x_rep = x.repeat_interleave(k, dim=1) if k > 1 else x              # (b, t, D)
    # each expert's buffer holds its (b, C) slots as b*C rows, so the three
    # products are batched over the experts alone (E, b*C, D) @ (E, D, F),
    # the reference's einsums without a copy of the weights a sequence; a
    # dropped choice is written to a spill row past them and never read, so
    # no index depends on how many choices were kept (a boolean index would
    # wait for the card each layer)
    row = torch.where(r.kept, rows * C + r.slot, b * C)
    buf = x.new_zeros(E, b * C + 1, D)
    buf[r.expert_ids, row] = x_rep
    buf = buf[:, :b * C]
    act = cm.activation_fn(cfg, torch.bmm(buf, p.wg.to(x.dtype)))      # (E, b*C, F)
    h = act * torch.bmm(buf, p.wu.to(x.dtype))
    out_buf = torch.bmm(h, p.wd.to(x.dtype))                           # (E, b*C, D)
    picked = out_buf[r.expert_ids, row.clamp(max=b * C - 1)]
    gated = r.gates.to(x.dtype)[..., None] * picked
    out = torch.where(r.kept[..., None], gated, torch.zeros((), dtype=x.dtype, device=x.device))
    if k > 1:
        out = out.reshape(b, s, k, D).sum(dim=2)
    if m.shared_expert:
        sp = p.shared
        g = cm.activation_fn(cfg, cm.dense(cfg, x, sp.wg))
        out = out + cm.dense(cfg, g * cm.dense(cfg, x, sp.wu), sp.wd)
    return out


def load_balance_loss(cfg: ModelConfig, logits: torch.Tensor,
                      expert_ids: torch.Tensor) -> torch.Tensor:
    """The Switch/GShard auxiliary load-balancing loss: E times the sum over
    experts of the mean router probability and the share of first choices."""
    E = cfg.moe.num_experts
    probs = torch.softmax(logits.to(torch.float32), -1)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[..., 0].long(), E).to(torch.float32).mean(dim=0)
    return E * (me * ce).sum()

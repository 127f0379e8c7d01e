"""The step functions (counterpart of `repro/launch/steps.py`): the training step,
the prefill step and the serving decode step.

A model's parameters are its float32 masters (`registry.init_params`); the
train step differentiates `registry.train_apply` and the cross entropy with
torch autograd, through the kernels' backward passes on the card, and
updates the parameters in place.
"""
from __future__ import annotations

import re
from typing import Dict, List

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import compression


def trainable(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name: the trees the optimizer, the
    checkpoint and the gradients are laid out as."""
    return dict(model.named_parameters())


def layer_stacks(names) -> Dict[str, List[str]]:
    """The reference's leaves over the port's parameter names: each block
    weight `layers.<i>.<path>` of every layer, in layer order, under one
    leaf `<path>` (the reference stacks them over a leading layer axis);
    every other name alone."""
    groups: Dict[str, List[str]] = {}
    order: Dict[str, List[int]] = {}
    for n in names:
        m = re.fullmatch(r"layers\.(\d+)\.(.+)", n)
        key = f"blocks.{m.group(2)}" if m else n
        groups.setdefault(key, []).append(n)
        order.setdefault(key, []).append(int(m.group(1)) if m else 0)
    return {k: [n for _, n in sorted(zip(order[k], v))] for k, v in groups.items()}


def compress_like_reference(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int8 error-feedback compression with a fresh zero error, one scale
    for each leaf of the reference's tree: a block weight's gradients of
    every layer share one (`layer_stacks`)."""
    stacks = layer_stacks(grads)
    stacked = {k: torch.stack([grads[n] for n in names]) for k, names in stacks.items()}
    deq, _ = compression.compress_decompress(stacked, compression.init_error(stacked))
    return {n: deq[k][i] for k, names in stacks.items() for i, n in enumerate(names)}


def build_train_step(run: RunConfig, keep_grads: bool = False):
    """(model, opt_state, batch) -> (model, opt_state, metrics): the loss and
    gradients of the batch (microbatched and accumulated in float32 when
    run.microbatch > 0), int8 error-feedback compression of the gradients
    (a fresh zero error each step and one scale a leaf of the reference's
    tree, as the reference's step has it: `compress_like_reference`), and one
    AdamW update written into the model's parameters in place (the
    reference donates its parameters and state to the step).  batch:
    {"tokens", "labels"} (B, S) integer tensors on the model's device, and
    for the vlm "embeds" (B, num_patches, D), whose positions' logits the
    loss drops.  With `keep_grads`, metrics["grads"] holds the gradients the
    update used."""
    cfg = run.model

    def loss_fn(model, batch):
        logits = registry.train_apply(cfg, model, batch["tokens"], remat=run.remat != "none",
                                      extra_embeds=batch.get("embeds"))
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_patches:]
        return cm.cross_entropy(logits, batch["labels"])

    def value_and_grad(model, batch):
        params = trainable(model)
        with torch.enable_grad():
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def grads_of(model, batch):
        mb = run.microbatch
        B = batch["tokens"].shape[0]
        if mb <= 0 or mb >= B:
            return value_and_grad(model, batch)
        n = B // mb
        lsum = None
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in trainable(model).items()}
        for i in range(n):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = value_and_grad(model, micro)
            for k in gsum:
                gsum[k] = gsum[k] + g[k].to(torch.float32)
            lsum = loss if lsum is None else lsum + loss
        return lsum / n, {k: g / n for k, g in gsum.items()}

    def train_step(model, opt_state, batch):
        loss, grads = grads_of(model, batch)
        if run.optimizer.grad_compression == "int8_ef":
            grads = compress_like_reference(grads)
        _, new_opt, metrics = adamw.update(run.optimizer, grads, opt_state, trainable(model))
        metrics["loss"] = loss
        if keep_grads:
            metrics["grads"] = grads
        return model, new_opt, metrics

    return train_step


def build_prefill_step(run: RunConfig):
    """(model, batch) -> the last position's logits (B, V), the next-token
    distribution serving starts from."""
    cfg = run.model

    @torch.no_grad()
    def prefill_step(model, batch):
        return registry.apply(cfg, model, batch["tokens"])[:, -1]

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    """One greedy decode step: (model, cache, tokens (B, S), pos) ->
    (next tokens (B, 1), cache), the argmax of the last position's logits."""

    def serve_step(model, cache, tokens, pos: int):
        logits, cache = registry.decode_step(cfg, model, cache, tokens, pos)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    return serve_step

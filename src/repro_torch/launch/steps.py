"""Serving step builders (counterpart of `build_decode_step` in
`repro/launch/steps.py`)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import registry


def build_decode_step(cfg: ModelConfig):
    """One greedy decode step: (model, cache, tokens (B, S), pos) ->
    (next tokens (B, 1), cache), the argmax of the last position's logits."""

    def serve_step(model, cache, tokens, pos: int):
        logits, cache = registry.decode_step(cfg, model, cache, tokens, pos)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    return serve_step

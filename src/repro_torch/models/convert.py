"""Weights from the reference's parameter tree (counterpart of the tree that
`repro.models.registry.init_params` builds for BERT).

The tree arrives as nested dicts of numpy arrays, with each block weight
stacked over a leading layer axis: `blocks.wq` (L, D, QD), `blocks.bq`
(L, QD), `blocks.mlp.w1` (L, D, F), `blocks.ln1.gamma` (L, D), ...
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig

_ATTN = ("wq", "bq", "wk", "bk", "wv", "bv", "wo")
_MLP = ("w1", "b1", "w2", "b2")


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A state dict for `Bert(cfg)`: float32 tensors, the layer axis unstacked.
    `Bert.load_state_dict` casts them to the model's dtype."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32, copy=True))
    state = {
        "embed": t(tree["embed"]),
        "pos_embed": t(tree["pos_embed"]),
        "type_embed": t(tree["type_embed"]),
    }
    for k, v in tree["ln_embed"].items():
        state[f"ln_embed.{k}"] = t(v)
    blocks = tree["blocks"]
    for i in range(cfg.num_layers):
        for name in _ATTN:
            state[f"layers.{i}.{name}"] = t(blocks[name][i])
        for name in _MLP:
            state[f"layers.{i}.{name}"] = t(blocks["mlp"][name][i])
        for ln in ("ln1", "ln2"):
            for k, v in blocks[ln].items():
                state[f"layers.{i}.{ln}.{k}"] = t(v[i])
    return state

"""Weights from the reference's parameter tree (counterpart of the tree that
`repro.models.registry.init_params` builds for BERT and for the dense, vlm
and moe decoders).

The tree arrives as nested dicts of numpy arrays, with each block weight
stacked over a leading layer axis: `blocks.wq` (L, D, QD), `blocks.bq`
(L, QD), `blocks.mlp.w1` (L, D, F), `blocks.ln1.gamma` (L, D), ...
KV caches convert both ways, so that tests can compare them.  The npec
executor takes the stacked tree itself (`param_tree_from_jax`), or the same
tree built from a port `Bert` or `Transformer` (`param_tree_from_model`),
as on the card, which has no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import layer_is_moe

_ATTN = ("wq", "bq", "wk", "bk", "wv", "bv", "wo")
_MLP = ("w1", "b1", "w2", "b2")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _flat(prefix: str, node, state: Dict[str, torch.Tensor], index=None) -> None:
    """state[prefix + dotted path] = each leaf of `node` (its row `index`)."""
    for k, v in node.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, state, index)
        else:
            state[prefix + k] = _tensor(v if index is None else v[index])


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A state dict for the port's model of `cfg` (`Bert` or `Transformer`):
    float32 tensors, the layer axis unstacked.  `load_state_dict` casts them
    to the model's dtype.  A decoder's tree maps path for path: `embed`,
    `lm_head` (absent with a tied embedding), `ln_f.gamma`, and
    `blocks.<path>[i]` to `layers.<i>.<path>` (`wq`, `bq`, `q_norm`,
    `ln1.gamma`, ...).  The MLP and MoE stacks hold only their own layers:
    `blocks.mlp.<path>[j]` goes to the j-th dense layer's `mlp.<path>`, and
    `blocks.moe.<path>[j]` (`router`, `wg`, `wu`, `wd`, `shared.wg`, ...)
    to the j-th MoE layer's `moe.<path>` (`transformer.layer_is_moe`)."""
    if cfg.family != "bert":
        state: Dict[str, torch.Tensor] = {}
        _flat("", {k: v for k, v in tree.items() if k != "blocks"}, state)
        blocks = tree["blocks"]
        shared = {k: v for k, v in blocks.items() if k not in ("mlp", "moe")}
        counts = {"mlp": 0, "moe": 0}
        for i, is_moe in enumerate(layer_is_moe(cfg)):
            _flat(f"layers.{i}.", shared, state, i)
            stack = "moe" if is_moe else "mlp"
            _flat(f"layers.{i}.{stack}.", blocks[stack], state, counts[stack])
            counts[stack] += 1
        return state
    t = _tensor
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


def param_tree_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    same nested dicts of float32 tensors on `device`: the same paths, the
    block weights still stacked over their leading layer axis."""
    if isinstance(tree, dict):
        return {k: param_tree_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32, copy=True)).to(device)


def param_tree_from_model(model) -> Dict[str, Any]:
    """The tree `param_tree_from_jax` gives, built from a port `Bert` or
    `Transformer`: its weights in float32 on the model's device, block
    weights stacked over the layer axis, as the reference's `init_params`
    lays them out.  A decoder's tree is `params_from_jax`'s mapping turned
    around: `embed`, `lm_head` (untied), `pos_embed` (learned positions),
    `ln_f`, and `blocks` with the attention weights, norms and qk-norms of
    every layer, `blocks.mlp` (wg/wu/wd or w1/b1/w2/b2) over the dense
    layers alone and `blocks.moe` (router, wg/wu/wd stacked over the
    experts, `shared`) over the MoE layers alone.
    Each stack is allocated in float32 once and filled a layer at a time,
    so beside the model and the tree there is at most one layer's weight
    in float32: GLM4-9B's tree (37.6 GB) fits beside its bf16 model."""
    if hasattr(model, "type_embed"):
        return _bert_tree(model)
    f = lambda t: t.detach().to(torch.float32)
    tree: Dict[str, Any] = {"embed": f(model.embed),
                            "ln_f": {k: f(v) for k, v in model.ln_f.named_parameters()}}
    if hasattr(model, "lm_head"):
        tree["lm_head"] = f(model.lm_head)
    if hasattr(model, "pos_embed"):
        tree["pos_embed"] = f(model.pos_embed)
    # each parameter name of a layer -> the layers that hold it, in order
    # (an mlp.* or moe.* name only the dense or the MoE layers)
    holders: Dict[str, list] = {}
    for layer in model.layers:
        for name, t in layer.named_parameters():
            holders.setdefault(name, []).append(t)
    blocks: Dict[str, Any] = {}
    for name, ts in holders.items():
        stacked = torch.empty((len(ts),) + tuple(ts[0].shape), dtype=torch.float32,
                              device=ts[0].device)
        for i, t in enumerate(ts):
            stacked[i].copy_(t.detach())
        node = blocks
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = stacked
    tree["blocks"] = blocks
    return tree


def _bert_tree(model) -> Dict[str, Any]:
    f = lambda t: t.detach().to(torch.float32)
    stack = lambda name: torch.stack([f(getattr(l, name)) for l in model.layers])

    def norm(get):
        out = {"gamma": torch.stack([f(get(l).gamma) for l in model.layers])}
        if hasattr(get(model.layers[0]), "beta"):
            out["beta"] = torch.stack([f(get(l).beta) for l in model.layers])
        return out

    ln = model.ln_embed
    return {
        "embed": f(model.embed), "pos_embed": f(model.pos_embed),
        "type_embed": f(model.type_embed),
        "ln_embed": {k: f(getattr(ln, k)) for k in ("gamma", "beta") if hasattr(ln, k)},
        "blocks": {**{name: stack(name) for name in _ATTN},
                   "mlp": {name: stack(name) for name in _MLP},
                   "ln1": norm(lambda l: l.ln1), "ln2": norm(lambda l: l.ln2)},
    }


def cache_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """A KV cache tree of numpy arrays (the reference's bf16 `{"full": {"k",
    "v"}}` and, with windowed layers, `"win"`, each (layers, B, rows, Hkv,
    D)) as bf16 tensors on `device`; the values pass through float32, which
    holds every bf16 value exactly."""
    return {group: {name: torch.from_numpy(np.array(a, np.float32, copy=True))
                    .to(device=device, dtype=torch.bfloat16)
                    for name, a in kv.items()}
            for group, kv in tree.items()}


def cache_to_numpy(cache: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """The cache as float32 numpy arrays, for comparison with the reference's."""
    return {group: {name: t.detach().to("cpu", torch.float32).numpy()
                    for name, t in kv.items()}
            for group, kv in cache.items()}

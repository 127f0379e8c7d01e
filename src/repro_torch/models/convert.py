"""Weights from the reference's parameter tree (counterpart of the tree that
`repro.models.registry.init_params` builds for every family).

The tree arrives as nested dicts of numpy arrays, with each block weight
stacked over a leading layer axis: `blocks.wq` (L, D, QD), `blocks.bq`
(L, QD), `blocks.mlp.w1` (L, D, F), `blocks.ln1.gamma` (L, D), ...
Caches (KV groups and recurrent states) convert both ways, so that tests
can compare them.  The npec executor takes the stacked tree itself
(`param_tree_from_jax`), or the same tree built from a port `Bert` or
`Transformer` (`param_tree_from_model`), as on the card, which has no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import registry
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
    """A state dict for the port's model of `cfg`: float32 tensors, the
    layer axis unstacked.  `load_state_dict` casts them to the model's
    dtype.  Paths map one for one: the top-level leaves (`embed`, `lm_head`,
    `ln_f.gamma`, rwkv6's `ln_in.*`, hybrid's `meta`, encdec's `pos_dec` and
    `ln_enc.*`) keep their names, and a stacked `blocks.<path>[i]` goes to
    `layers.<i>.<path>` (`wq`, `ln1.gamma`, rwkv6's `att.mix.mu` and
    `ffn.wk`, hybrid's `ssm.in_proj`, ...), encdec's `enc_blocks.<path>[i]`
    and `dec_blocks.<path>[i]` (with `cross.*`) to `enc_blocks.<i>.<path>`
    and `dec_blocks.<i>.<path>`.  A decoder's MLP and MoE stacks hold only
    their own layers: `blocks.mlp.<path>[j]` goes to the j-th dense layer's
    `mlp.<path>`, and `blocks.moe.<path>[j]` (`router`, `wg`, `wu`, `wd`,
    `shared.wg`, ...) to the j-th MoE layer's `moe.<path>`
    (`transformer.layer_is_moe`)."""
    if cfg.family == "encdec":
        state: Dict[str, torch.Tensor] = {}
        _flat("", {k: v for k, v in tree.items() if not k.endswith("blocks")}, state)
        for stack, n in (("enc_blocks", cfg.encoder_layers), ("dec_blocks", cfg.decoder_layers)):
            for i in range(n):
                _flat(f"{stack}.{i}.", tree[stack], state, i)
        return state
    if cfg.family != "bert":
        state = {}
        _flat("", {k: v for k, v in tree.items() if k != "blocks"}, state)
        blocks = tree["blocks"]
        shared = {k: v for k, v in blocks.items() if k not in ("mlp", "moe")}
        counts = {"mlp": 0, "moe": 0}
        for i, is_moe in enumerate(layer_is_moe(cfg)):
            _flat(f"layers.{i}.", shared, state, i)
            stack = "moe" if is_moe else "mlp"
            if stack in blocks:
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


def _decoder_leaves(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[str, ...], Optional[int]]]:
    """`reference_leaves` of a decoder, from its parameter names: a top-level
    name is its own path; `layers.<i>.<path>` is `blocks.<path>` at row i,
    and `layers.<i>.mlp.<path>` or `layers.<i>.moe.<path>` the row of layer
    i among the dense or the MoE layers (`transformer.layer_is_moe`: llama4
    interleaves them)."""
    rows, counts = [], {"mlp": 0, "moe": 0}
    for is_moe in layer_is_moe(cfg):
        stack = "moe" if is_moe else "mlp"
        rows.append(counts[stack])
        counts[stack] += 1
    out: Dict[str, Tuple[Tuple[str, ...], Optional[int]]] = {}
    for name, _ in registry.build_model(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = (tuple(parts), None)
            continue
        i, path = int(parts[1]), tuple(parts[2:])
        out[name] = (("blocks",) + path, rows[i] if path[0] in ("mlp", "moe") else i)
    return out


def reference_leaves(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[str, ...], Optional[int]]]:
    """For BERT and the dense, vlm and moe decoders: each port parameter's
    name -> (its leaf's path in the reference's `init_params` tree, its row
    of that stacked leaf, or None for a leaf that is not stacked), the
    mapping `params_from_jax` applies, so that a reference gradient tree can
    be compared with the port's gradients leaf by leaf.  The reference's
    unused pooler has no port parameter."""
    if cfg.family in ("dense", "vlm", "moe"):
        return _decoder_leaves(cfg)
    if cfg.family != "bert":
        raise NotImplementedError(f"reference_leaves: {cfg.family}, which does not train")
    out: Dict[str, Tuple[Tuple[str, ...], Optional[int]]] = {
        "embed": (("embed",), None), "pos_embed": (("pos_embed",), None),
        "type_embed": (("type_embed",), None)}
    for k in ("gamma",) + (("beta",) if cfg.norm_bias else ()):
        out[f"ln_embed.{k}"] = (("ln_embed", k), None)
    for i in range(cfg.num_layers):
        for name in _ATTN:
            out[f"layers.{i}.{name}"] = (("blocks", name), i)
        for name in _MLP:
            out[f"layers.{i}.{name}"] = (("blocks", "mlp", name), i)
        for ln in ("ln1", "ln2"):
            for k in ("gamma",) + (("beta",) if cfg.norm_bias else ()):
                out[f"layers.{i}.{ln}.{k}"] = (("blocks", ln, k), i)
    return out


def reference_leaf(tree: Dict[str, Any], where: Tuple[Tuple[str, ...], Optional[int]]):
    """The leaf (or its row) of `tree` at a `reference_leaves` entry."""
    path, index = where
    for k in path:
        tree = tree[k]
    return tree if index is None else tree[index]


def masters_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cpu"):
    """The port's model of `cfg` with float32 master weights from the
    reference's float32 `init_params` tree: what the trainer starts from."""
    model = registry.build_model(cfg, device=device, dtype=torch.float32)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


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


def cache_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A cache tree of numpy arrays (the reference's: bf16 KV groups such as
    `{"full": {"k", "v"}}`, float32 recurrent states such as rwkv6's
    `state`, cfg.dtype token-shift and conv states) as the same tree of
    tensors on `device`, each leaf in its own dtype (bf16 or float32); the
    values pass through float32, which holds every bf16 value exactly."""
    if isinstance(tree, dict):
        return {k: cache_from_jax(v, device) for k, v in tree.items()}
    dtype = torch.float32 if np.dtype(tree.dtype) == np.float32 else torch.bfloat16
    return torch.from_numpy(np.array(tree, np.float32, copy=True)).to(device=device, dtype=dtype)


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The cache tree as float32 numpy arrays, for comparison with the reference's."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    return cache.detach().to("cpu", torch.float32).numpy()

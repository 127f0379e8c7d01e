"""Decoder-only transformer (counterpart of `repro/models/transformer.py`).

One implementation covers the reference's dense, vlm and moe stacks:
  * pre-norm GQA blocks (glm4, the qwen2-vl text backbone);
  * parallel attention + MLP blocks off one norm (command-r-plus);
  * sliding-window layers (starcoder2) and local:global patterns (gemma3,
    every `global_every`-th layer global), the attention logit soft cap;
  * MoE blocks every `interleave`-th layer (granite: every layer; llama4:
    every second, dense MLPs between) through models/moe.py;
  * qkv bias, qk-norm, RoPE, M-RoPE or learned positions, gated or plain
    MLP, RMSNorm or LayerNorm, tied or untied head;
  * NPE mode: projections through the MMU, norms, activations and the
    attention softmax through the NVU (models/common.py).

The reference scans over stacked layers (super-blocks of one local:global
period or one dense/MoE interleave); here each layer is a module with its
own window and its own MLP or MoE, and the stack a Python loop, which gives
the same function.  Weights are held in cfg.dtype (the reference casts its
float32 masters to cfg.dtype once per call, biases and gammas included).
Attention, with or without a cache, is the flash kernel's dense mode: one
softmax over every visible key.

The KV cache holds two groups, as the reference's: `full` (layers with
window 0, max_seq rows, appended at pos) and `win` (windowed layers, a ring
of min(window, max_seq) rows written at pos % its length).  A ring takes one
token a call; `launch/serve.py` prefills such a model one token at a time.

`forward_train` is `apply` with gradients for the trainer: the model holds
float32 masters, cast to cfg.dtype on each call as the reference's
`registry.apply` casts its tree (`cast_params`, a layer at a time inside
each layer's activation checkpoint), and the attention is the dense mode
through its autograd Function (`kernels/ops.DenseAttentionFn`, backward
kernel `dense_attention_grad`).

Not ported: a bidirectional decoder (cfg.causal False), which raises
NotImplementedError.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Norm, param

KV = Tuple[torch.Tensor, torch.Tensor]
ONES = ("gamma", "q_norm", "k_norm")    # initialised to one; other vectors to zero
SCALES = dict.fromkeys(("embed", "pos_embed", "router"), 0.02)  # normal x 0.02


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this module does not port yet."""
    if not cfg.causal:
        raise NotImplementedError(f"{cfg.name}: a bidirectional decoder is not ported")


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Each layer's attention window (0: full causal attention)."""
    L = cfg.num_layers
    if cfg.attention == "sliding":
        return np.full((L,), cfg.window, np.int32)
    if cfg.attention == "local_global":
        w = np.full((L,), cfg.window, np.int32)
        w[cfg.global_every - 1::cfg.global_every] = 0      # every Nth is global
        return w
    return np.zeros((L,), np.int32)


def layer_is_moe(cfg: ModelConfig) -> np.ndarray:
    """Whether each layer's MLP is an MoE block: every `interleave`-th."""
    flags = np.zeros((cfg.num_layers,), bool)
    if cfg.moe:
        flags[cfg.moe.interleave - 1::cfg.moe.interleave] = True
    return flags


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        if cfg.mlp_type == "gated":
            self.wg, self.wu, self.wd = param(D, F, **kw), param(D, F, **kw), param(F, D, **kw)
            return
        self.w1, self.w2 = param(D, F, **kw), param(F, D, **kw)
        if cfg.mlp_bias:
            self.b1, self.b2 = param(F, **kw), param(D, **kw)


class Block(nn.Module):
    """One layer: attention and norms, and an MLP or (is_moe) an MoE block."""

    def __init__(self, cfg: ModelConfig, is_moe: bool = False, **kw):
        super().__init__()
        D, QD, KD = cfg.d_model, cfg.q_dim(), cfg.kv_dim()
        norm_bias = cfg.norm == "layernorm" and cfg.norm_bias
        self.ln1 = Norm(D, norm_bias, **kw)
        self.wq, self.wk, self.wv = param(D, QD, **kw), param(D, KD, **kw), param(D, KD, **kw)
        self.wo = param(QD, D, **kw)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = param(QD, **kw), param(KD, **kw), param(KD, **kw)
        if cfg.qk_norm:
            self.q_norm = param(cfg.head_dim, **kw)
            self.k_norm = param(cfg.head_dim, **kw)
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)
        if not cfg.parallel_block:
            self.ln2 = Norm(D, norm_bias, **kw)
        if is_moe:
            self.moe = moe_mod.MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)


class Transformer(nn.Module):
    """A decoder's weights.  `cfg` sets the shapes and the default numerics;
    `apply`/`decode_step` take a config of the same shapes, so one set of
    weights serves float, NPE-8 and NPE-16."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Transformer(device='cuda'): no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        kw = dict(device=device, dtype=dtype or getattr(torch, cfg.dtype))
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = param(V, D, **kw)
        if cfg.rope == "learned":
            self.pos_embed = param(cfg.max_position, D, **kw)
        self.ln_f = Norm(D, cfg.norm == "layernorm" and cfg.norm_bias, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = param(D, V, **kw)
        self.layers = nn.ModuleList(Block(cfg, bool(m), **kw) for m in layer_is_moe(cfg))

    def head(self) -> torch.Tensor:
        """The (D, V) logits table."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def init(self, generator: torch.Generator) -> "Transformer":
        """Random weights with the reference's scales (`common._init_leaf`):
        normal x 0.02 for the embeddings and the MoE router, normal x
        fan_in^-0.5 for the matrices (fan_in the second-to-last axis, so an
        expert stack's D or F), ones for gammas and qk-norms, zeros for the
        other vectors (`common.init_weights`: one tensor at a time, so the
        largest temporary is one tensor, not a second copy of the model)."""
        return cm.init_weights(self, generator, ONES, (), SCALES)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


Model = Transformer


def _attn(cfg: ModelConfig, p: Block, x: torch.Tensor, positions: torch.Tensor,
          window: int = 0, cache: Optional[KV] = None, pos: Optional[int] = None,
          ring: bool = False) -> torch.Tensor:
    """The attention sublayer.  With `cache`, this layer's (B, rows, Hkv, D)
    k and v: the new k/v are written in place at `pos` and the queries
    attend over the cache, each to the positions <= its own; with `ring`, the
    cache is a window layer's ring, written at pos % rows and read with
    causality off over its min(pos + 1, rows) written rows.  Without a
    cache, causally over x itself, within `window` when it is > 0."""
    b, s, _ = x.shape
    q = cm.dense(cfg, x, p.wq, getattr(p, "bq", None)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = cm.dense(cfg, x, p.wk, getattr(p, "bk", None)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = cm.dense(cfg, x, p.wv, getattr(p, "bv", None)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = cm.norm(cfg, q, p.q_norm)
        k = cm.norm(cfg, k, p.k_norm)
    if cfg.rope == "standard":
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = cm.apply_mrope(q, positions, cfg.rope_theta)
        k = cm.apply_mrope(k, positions, cfg.rope_theta)
    if cache is None:                  # causal self-attention: x's keys are the cache
        out = cm.attention_over_cache(cfg, q, k, v, 0, window=int(window))
    elif ring:
        rows = cache[0].shape[1]
        ck, cv = cm.update_cache_layer(cache[0], cache[1], k, v, pos % rows)
        out = cm.attention_over_cache(cfg, q, ck, cv, pos, ring=rows)
    else:
        ck, cv = cm.update_cache_layer(cache[0], cache[1], k, v, pos)
        out = cm.attention_over_cache(cfg, q, ck, cv, pos)
    return cm.dense(cfg, out.reshape(b, s, cfg.q_dim()), p.wo)


def _mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "gated":
        g = cm.activation_fn(cfg, cm.dense(cfg, x, p.wg))
        return cm.dense(cfg, g * cm.dense(cfg, x, p.wu), p.wd)
    h = cm.activation_fn(cfg, cm.dense(cfg, x, p.w1, getattr(p, "b1", None)))
    return cm.dense(cfg, h, p.w2, getattr(p, "b2", None))


def _ffn(cfg: ModelConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    """The layer's MoE block or MLP."""
    if hasattr(p, "moe"):
        return moe_mod.apply(cfg, p.moe, x)
    return _mlp(cfg, p.mlp, x)


def block(cfg: ModelConfig, p: Block, x: torch.Tensor, positions: torch.Tensor,
          window: int = 0, cache: Optional[KV] = None, pos: Optional[int] = None,
          ring: bool = False) -> torch.Tensor:
    h = cm.apply_norm(cfg, p.ln1, x)
    a = _attn(cfg, p, h, positions, window, cache, pos, ring)
    if cfg.parallel_block:             # command-r: attention and MLP read one norm
        return x + a + _mlp(cfg, p.mlp, h)
    x = x + a
    return x + _ffn(cfg, p, cm.apply_norm(cfg, p.ln2, x))


def _positions(cfg: ModelConfig, b: int, s: int, start: int, device) -> torch.Tensor:
    """(B, S) positions start..start+S-1, or (B, S, 3) equal t/h/w ids for M-RoPE."""
    positions = (start + torch.arange(s, device=device)).expand(b, s)
    if cfg.rope == "mrope":
        positions = positions[..., None].expand(b, s, 3)
    return positions


def _embed(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return cm.embed(tokens, model.embed).to(getattr(torch, cfg.dtype))


@torch.no_grad()
def apply(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None,
          extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S', V).  extra_embeds: optional (B, P, D)
    continuous embeddings (the VLM stub's patches) put ahead of the token
    embeddings, so S' = P + S."""
    check_supported(cfg)
    x = _embed(cfg, model, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(cfg, b, s, 0, x.device)
    if cfg.rope == "learned":
        x = x + model.pos_embed[:s][None].to(x.dtype)
    for layer, window in zip(model.layers, layer_windows(cfg)):
        x = block(cfg, layer, x, positions, int(window))
    x = cm.apply_norm(cfg, model.ln_f, x)
    return cm.logits_out(cfg, x, model.head())


def cast_params(module: nn.Module, dtype: torch.dtype) -> SimpleNamespace:
    """`module`'s weights cast to `dtype` (differentiably: a gradient goes back
    to each master in its own dtype; a weight already in `dtype` is itself),
    as an attribute tree with the module's names, which `block` reads as it
    reads the module: the reference's `cast_tree` of its masters."""
    ns = SimpleNamespace(**{n: p.to(dtype) for n, p in module.named_parameters(recurse=False)})
    for n, child in module.named_children():
        setattr(ns, n, cast_params(child, dtype))
    return ns


def _train_block(cfg: ModelConfig, layer: Block, x: torch.Tensor, positions: torch.Tensor,
                 window: int) -> torch.Tensor:
    return block(cfg, cast_params(layer, getattr(torch, cfg.dtype)), x, positions, window)


def forward_train(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
                  remat: bool = True,
                  extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`apply` with gradients: tokens (B, S) -> logits (B, S', V), S' = P + S
    with extra_embeds (B, P, D) put ahead of the token embeddings (the vlm).
    The float32 masters are cast to cfg.dtype as the reference casts them
    (the embedding table once, for the lookup and a tied head; each layer's
    weights inside its own call); with `remat`, each layer runs under
    `torch.utils.checkpoint` (its forward runs again in the backward pass,
    kernels included)."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    table = model.embed.to(dt)
    x = cm.embed(tokens, table)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dt), x], dim=1)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, 0, x.device)
    if cfg.rope == "learned":
        x = x + model.pos_embed[:s][None].to(dt)
    for layer, window in zip(model.layers, layer_windows(cfg)):
        if remat:
            x = checkpoint(_train_block, cfg, layer, x, positions, int(window),
                           use_reentrant=False)
        else:
            x = _train_block(cfg, layer, x, positions, int(window))
    x = cm.apply_norm(cfg, cast_params(model.ln_f, dt), x)
    return cm.logits_out(cfg, x, table.T if cfg.tie_embeddings else model.lm_head.to(dt))


def _cache_groups(cfg: ModelConfig, max_seq: int) -> Dict[str, Tuple[int, int]]:
    """{group: (layers, rows)}: `full` for the layers with window 0 (max_seq
    rows), `win` for the windowed ones (min(window, max_seq) rows), each
    present only when it has layers, in the reference's order."""
    windows = layer_windows(cfg)
    out = {}
    if (windows == 0).any():
        out["full"] = (int((windows == 0).sum()), max_seq)
    if (windows > 0).any():
        out["win"] = (int((windows > 0).sum()), min(int(windows[windows > 0][0]), max_seq))
    return out


def cache_layers(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Each layer's (cache group, index in the group's stack): `win` for a
    windowed layer, `full` for the others, in layer order."""
    index = {"full": 0, "win": 0}
    out = []
    for window in layer_windows(cfg):
        group = "win" if window > 0 else "full"
        out.append((group, index[group]))
        index[group] += 1
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Dict]:
    """Shapes and dtypes of the KV cache, keyed as the reference's tree: a
    stacked group for the full layers and one for the windowed layers'
    rings (`_cache_groups`)."""
    check_supported(cfg)
    return {group: {name: ((layers, batch, rows, cfg.num_kv_heads, cfg.head_dim),
                           cm.CACHE_DTYPE) for name in ("k", "v")}
            for group, (layers, rows) in _cache_groups(cfg, max_seq).items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """A zeroed cache of `cache_specs`' layout."""
    check_supported(cfg)
    return {group: cm.kv_cache(cfg, layers, batch, rows, device)
            for group, (layers, rows) in _cache_groups(cfg, max_seq).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, cache, tokens: torch.Tensor,
                pos: int):
    """tokens (B, S) at positions pos..pos+S-1 (S > 1 is a prefill); pos is
    the current cache length.  Returns (logits (B, S, V), cache): the new
    k/v are written into `cache` in place.  A full layer appends at pos and
    each token attends to the cached positions <= its own; a window layer
    writes its ring at pos % its rows and attends over the written rows
    (S = 1 only: the reference's multi-token call on a ring is not causal)."""
    check_supported(cfg)
    x = _embed(cfg, model, tokens)
    b, s, _ = x.shape
    if "win" in cache and s != 1:
        raise ValueError(f"decode_step: {s} tokens into a cache with window rings; "
                         "prefill them one at a time")
    positions = _positions(cfg, b, s, pos, x.device)
    if cfg.rope == "learned":
        x = x + model.pos_embed[pos:pos + s][None].to(x.dtype)
    for layer, (group, i) in zip(model.layers, cache_layers(cfg)):
        kv = (cache[group]["k"][i], cache[group]["v"][i])
        x = block(cfg, layer, x, positions, cache=kv, pos=pos, ring=group == "win")
    x = cm.apply_norm(cfg, model.ln_f, x)
    return cm.logits_out(cfg, x, model.head()), cache

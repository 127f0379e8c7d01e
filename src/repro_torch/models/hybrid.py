"""Hymba-style hybrid (counterpart of `repro/models/hybrid.py`): attention and
an SSM head in parallel in every layer.

Each block computes, from the same normed input, GQA attention over a
sliding window (full attention every `global_every`-th layer) through
`transformer._attn`, and a Mamba selective-SSM head (models/ssm.py); the two
branches are normed on their own and fused by their mean, then an MLP
follows.  `apply` puts 128 learned meta tokens ahead of the sequence and
drops their logits.  `decode_step` does not prepend them, as the
reference's does not: a decoded sequence starts at position 0 with no meta
tokens, so it is not the teacher-forced `apply`.

The cache holds the transformer's `full` and `win` groups (rings of
min(window, max_seq) rows, written one token a call) and the SSM's `ssm`
(float32) and `conv` states; every tensor is written in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import Norm, param


def meta_tokens(cfg: ModelConfig) -> int:
    return 128 if cfg.family == "hybrid" else 0


class Block(tf.Block):
    """A transformer block's attention, norms and MLP, plus the per-branch
    norms and the SSM head."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__(cfg, **kw)
        bias = cfg.norm == "layernorm" and cfg.norm_bias
        self.attn_norm = Norm(cfg.d_model, bias, **kw)
        self.ssm_norm = Norm(cfg.d_model, bias, **kw)
        self.ssm = ssm_mod.Mamba(cfg, **kw)


class Hybrid(nn.Module):
    """The hybrid's weights, named as the reference's tree (`blocks.<path>` is
    `layers.<i>.<path>`)."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=None):
        super().__init__()
        tf.check_supported(cfg)
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Hybrid(device='cuda'): no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        kw = dict(device=device, dtype=dtype or getattr(torch, cfg.dtype))
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = param(V, D, **kw)
        self.ln_f = Norm(D, cfg.norm == "layernorm" and cfg.norm_bias, **kw)
        self.lm_head = param(D, V, **kw)
        if meta_tokens(cfg):
            self.meta = param(meta_tokens(cfg), D, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))

    def init(self, generator: torch.Generator) -> "Hybrid":
        """Random weights with the reference's initialisers (`hybrid.specs`)."""
        return cm.init_weights(self, generator, ("gamma",) + ssm_mod.ONES, (),
                               dict(ssm_mod.SCALES, embed=0.02, meta=0.02))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


Model = Hybrid


def _block(cfg: ModelConfig, p: Block, x, positions, window, ssm_state, conv_state,
           cache=None, pos=None, ring=False):
    """Returns (x, new SSM state, new conv state)."""
    h = cm.apply_norm(cfg, p.ln1, x)
    attn_out = tf._attn(cfg, p, h, positions, window, cache, pos, ring)
    ssm_out, new_state, new_conv = ssm_mod.apply_layer(cfg, p.ssm, h, ssm_state, conv_state)
    fused = 0.5 * (cm.apply_norm(cfg, p.attn_norm, attn_out)
                   + cm.apply_norm(cfg, p.ssm_norm, ssm_out))
    x = x + fused
    h2 = cm.apply_norm(cfg, p.ln2, x)
    return x + tf._mlp(cfg, p.mlp, h2), new_state, new_conv


def _head(cfg: ModelConfig, model: Hybrid, x):
    return cm.logits_out(cfg, cm.apply_norm(cfg, model.ln_f, x), model.lm_head)


@torch.no_grad()
def apply(cfg: ModelConfig, model: Hybrid, tokens: torch.Tensor, positions=None,
          extra_embeds=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V): the meta tokens ahead of the
    sequence (their logits dropped), causal attention within each layer's
    window, every SSM from a zero state."""
    x = tf._embed(cfg, model, tokens)
    b, _, D = x.shape
    mt = meta_tokens(cfg)
    if mt:
        x = torch.cat([model.meta.to(x.dtype).expand(b, mt, D), x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = tf._positions(cfg, b, s, 0, x.device)
    di, N, _ = ssm_mod.dims(cfg)
    K = cfg.ssm.conv_dim
    for layer, window in zip(model.layers, tf.layer_windows(cfg)):
        st = torch.zeros((b, di, N), dtype=torch.float32, device=x.device)
        cv = x.new_zeros((b, K - 1, di))
        x, _, _ = _block(cfg, layer, x, positions, int(window), st, cv)
    return _head(cfg, model, x)[:, mt:]


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, object]:
    """The transformer's `full` / `win` KV groups and the SSM's `ssm` and
    `conv` states, keyed as the reference's tree."""
    out = tf.cache_specs(cfg, batch, max_seq)
    out.update(ssm_mod.state_specs(cfg, cfg.num_layers, batch))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> Dict[str, object]:
    """A zeroed cache of `cache_specs`' layout."""
    out = tf.init_cache(cfg, batch, max_seq, device)
    out.update({name: torch.zeros(shape, dtype=dt, device=device) for name, (shape, dt)
                in ssm_mod.state_specs(cfg, cfg.num_layers, batch).items()})
    return out


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Hybrid, cache, tokens: torch.Tensor, pos: int):
    """tokens (B, 1) at position pos, with no meta tokens (as the reference)
    -> (logits (B, 1, V), cache); a full layer appends its k/v at pos, a
    window layer writes its ring at pos % its rows, and every SSM state
    advances, all in place."""
    x = tf._embed(cfg, model, tokens)
    b, s, _ = x.shape
    if "win" in cache and s != 1:
        raise ValueError(f"decode_step: {s} tokens into a cache with window rings; "
                         "prefill them one at a time")
    positions = tf._positions(cfg, b, s, pos, x.device)
    for li, (group, i) in enumerate(tf.cache_layers(cfg)):
        kv = (cache[group]["k"][i], cache[group]["v"][i])
        st, cv = cache["ssm"][li], cache["conv"][li]
        x, new_st, new_cv = _block(cfg, model.layers[li], x, positions, 0, st, cv,
                                   cache=kv, pos=pos, ring=group == "win")
        st.copy_(new_st)
        cv.copy_(new_cv)
    return _head(cfg, model, x), cache

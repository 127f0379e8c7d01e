"""BERT (counterpart of `repro/models/bert.py`): the bidirectional encoder
(`apply`, `encode`) and the causal KV-cache serving step (`decode_step`).

Post-norm blocks, as in the paper's Table 1:
    X1 = MultiHeadAttention(X);      X2 = LayerNorm(X + X1)
    X3 = GELU(X2 W1 + b1);  X4 = X3 W2 + b2;  X5 = LayerNorm(X2 + X4)
Served weights are held in cfg.dtype.  For training (`forward_train`) they
are float32 masters, cast to cfg.dtype on each call as the reference casts
them (the embedding rows here, each projection's weight in `dense`), and
each layer may run under activation checkpointing (the reference's
`jax.checkpoint`).  The unused pooler is not carried.

`decode_step` is not equivalent to `apply`: BERT attends both ways, the
decode step only to cached positions <= its own.  It is the stream an
overlay runs when serving BERT-style stacks autoregressively, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import Norm
from repro_torch.models.common import param as _param

LN_EPS = 1e-12
KV = Tuple[torch.Tensor, torch.Tensor]


class BertLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D, QD, KD, F = cfg.d_model, cfg.q_dim(), cfg.kv_dim(), cfg.d_ff
        self.wq, self.bq = _param(D, QD, **kw), _param(QD, **kw)
        self.wk, self.bk = _param(D, KD, **kw), _param(KD, **kw)
        self.wv, self.bv = _param(D, KD, **kw), _param(KD, **kw)
        self.wo = _param(QD, D, **kw)
        self.ln1 = Norm(D, cfg.norm_bias, **kw)
        self.w1, self.b1 = _param(D, F, **kw), _param(F, **kw)
        self.w2, self.b2 = _param(F, D, **kw), _param(D, **kw)
        self.ln2 = Norm(D, cfg.norm_bias, **kw)

    def attn(self, cfg: ModelConfig, x: torch.Tensor, cache: Optional[KV] = None,
             pos: Optional[int] = None) -> Tuple[torch.Tensor, Optional[KV]]:
        """`transformer._attn`: dense q/k/v, attention, dense out.

        Without a cache, bidirectional attention over x.  With `cache`, this
        layer's (B, max_seq, Hkv, D) k and v: the new k/v are written in
        place at `pos` and x's queries attend causally over the cache.
        Returns the output and the cache (None without one)."""
        b, s, _ = x.shape
        q = cm.dense(cfg, x, self.wq, self.bq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = cm.dense(cfg, x, self.wk, self.bk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = cm.dense(cfg, x, self.wv, self.bv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cache is None:
            out = cm.attention_scores(cfg, q, k, v)
        else:
            cache = cm.update_cache_layer(cache[0], cache[1], k, v, pos)
            out = cm.attention_over_cache(cfg, q, cache[0], cache[1], pos)
        return cm.dense(cfg, out.reshape(b, s, cfg.q_dim()), self.wo), cache

    def mlp(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """`transformer._mlp`, plain type: GELU(x W1 + b1) W2 + b2."""
        h = cm.activation_fn(cfg, cm.dense(cfg, x, self.w1, self.b1))
        return cm.dense(cfg, h, self.w2, self.b2)

    def forward(self, cfg: ModelConfig, x: torch.Tensor, cache: Optional[KV] = None,
                pos: Optional[int] = None) -> torch.Tensor:
        a, _ = self.attn(cfg, x, cache, pos)
        x = cm.apply_norm(cfg, self.ln1, x + a, eps=LN_EPS)
        return cm.apply_norm(cfg, self.ln2, x + self.mlp(cfg, x), eps=LN_EPS)


class Bert(nn.Module):
    """BERT-base weights and forward.  `cfg` sets the shapes and the default
    numerics; `apply`/`encode` take a config of the same shapes, so one set of
    weights serves float, NPE-8 and NPE-16."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=None):
        super().__init__()
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Bert(device='cuda'): no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        kw = dict(device=device, dtype=dtype or getattr(torch, cfg.dtype))
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param(V, D, **kw)
        self.pos_embed = _param(cfg.max_position, D, **kw)
        self.type_embed = _param(2, D, **kw)
        self.ln_embed = Norm(D, cfg.norm_bias, **kw)
        self.layers = nn.ModuleList(BertLayer(cfg, **kw) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Bert":
        """Random weights with the reference's shapes and scales
        (`common._init_leaf`): normal x 0.02 for the embeddings, normal x
        fan_in^-0.5 for the matrices, zeros for biases and betas, ones for
        gammas.  Draws on the generator's device, in float32."""
        return cm.init_weights(self, generator, ("gamma",), (),
                               dict.fromkeys(("embed", "pos_embed", "type_embed"), 0.02))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


Model = Bert


def _embed(cfg: ModelConfig, model: Bert, tokens: torch.Tensor,
           pos: int = 0) -> torch.Tensor:
    s = tokens.shape[1]
    x = cm.embed(tokens, model.embed).to(getattr(torch, cfg.dtype))
    x = x + model.pos_embed[pos:pos + s][None].to(x.dtype)
    x = x + model.type_embed[0][None, None].to(x.dtype)
    return cm.apply_norm(cfg, model.ln_embed, x, eps=LN_EPS)


@torch.no_grad()
def encode(cfg: ModelConfig, model: Bert, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> sequence embeddings (B, S, D)."""
    x = _embed(cfg, model, tokens)
    for layer in model.layers:
        x = layer(cfg, x)
    return x


@torch.no_grad()
def apply(cfg: ModelConfig, model: Bert, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> MLM logits (B, S, V) through the tied embedding."""
    return cm.logits_out(cfg, encode(cfg, model, tokens), model.embed.T)


def forward_train(cfg: ModelConfig, model: Bert, tokens: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """`apply` with gradients: tokens (B, S) -> MLM logits (B, S, V).  With
    `remat`, each layer runs under `torch.utils.checkpoint` (its activations
    are recomputed in the backward pass, so its forward runs twice)."""
    x = _embed(cfg, model, tokens)
    for layer in model.layers:
        x = checkpoint(layer, cfg, x, use_reentrant=False) if remat else layer(cfg, x)
    return cm.logits_out(cfg, x, model.embed.T)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Dict]:
    """Shapes and dtypes of the full-attention KV cache of every layer (BERT
    has no window layers), keyed as the reference's cache tree."""
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"full": {name: (shape, cm.CACHE_DTYPE) for name in ("k", "v")}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """A zeroed cache of `cache_specs`' layout."""
    return {"full": cm.kv_cache(cfg, cfg.num_layers, batch, max_seq, device)}


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Bert, cache, tokens: torch.Tensor,
                pos: int):
    """tokens (B, S) at positions pos..pos+S-1 (S > 1 is a prefill); pos is
    the current cache length.  Returns (logits (B, S, V), cache): the new
    k/v are written into `cache` in place, and each token attends to the
    cached positions <= its own."""
    x = _embed(cfg, model, tokens, pos)
    ck, cv = cache["full"]["k"], cache["full"]["v"]
    for li, layer in enumerate(model.layers):
        x = layer(cfg, x, cache=(ck[li], cv[li]), pos=pos)
    return cm.logits_out(cfg, x, model.embed.T), cache

"""Decoder-only transformer, full attention (counterpart of
`repro/models/transformer.py`).

One implementation covers the reference's dense and vlm stacks whose
layers all attend in full:
  * pre-norm GQA blocks (glm4, the qwen2-vl text backbone);
  * parallel attention + MLP blocks off one norm (command-r-plus);
  * qkv bias, qk-norm, RoPE, M-RoPE or learned positions, gated or plain
    MLP, RMSNorm or LayerNorm, tied or untied head;
  * NPE mode: projections through the MMU, norms, activations and the
    attention softmax through the NVU (models/common.py).

The reference scans over stacked layers; here each layer is a module and
the stack a Python loop.  Weights are held in cfg.dtype (the reference casts
its float32 masters to cfg.dtype once per call, biases and gammas included).
Attention, with or without a cache, is the flash kernel's dense mode: one
softmax over every visible key.

Not ported yet (ROADMAP queue 1, item 6): sliding-window and local:global
layers (starcoder2, gemma3), whose ring caches need a validity mask the
dense mode does not take, attention logit soft-capping, and MoE blocks
(granite, llama4).  They raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import Norm, param

KV = Tuple[torch.Tensor, torch.Tensor]
ONES = ("gamma", "q_norm", "k_norm")    # initialised to one; other vectors to zero


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this module does not port yet."""
    if cfg.attention != "full":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} (ring caches with a validity mask) is "
            "not ported; ROADMAP queue 1, item 6 (sliding-window and local:global layers)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks (models/moe.py) are not ported; ROADMAP queue 1, item 6")
    if cfg.logit_softcap > 0:
        raise NotImplementedError(
            f"{cfg.name}: attention logit soft-capping is not ported; ROADMAP queue 1, item 6")
    if not cfg.causal:
        raise NotImplementedError(f"{cfg.name}: a bidirectional decoder is not ported")


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
    def __init__(self, cfg: ModelConfig, **kw):
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
        self.layers = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))

    def head(self) -> torch.Tensor:
        """The (D, V) logits table."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Random weights with the reference's scales (`common._init_leaf`):
        normal x 0.02 for the embeddings, normal x fan_in^-0.5 for the
        matrices, ones for gammas and qk-norms, zeros for the other vectors.
        Drawn in float32 on the generator's device one tensor at a time, so
        the largest temporary is one tensor, not a second copy of the model."""
        dev = generator.device
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ONES:
                p.fill_(1.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                scale = 0.02 if "embed" in leaf else p.shape[-2] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator, device=dev).mul_(scale))
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


Model = Transformer


def _attn(cfg: ModelConfig, p: Block, x: torch.Tensor, positions: torch.Tensor,
          cache: Optional[KV] = None, pos: Optional[int] = None) -> torch.Tensor:
    """The attention sublayer.  With `cache`, this layer's (B, max_seq, Hkv,
    D) k and v: the new k/v are written in place at `pos` and the queries
    attend over the cache, each to the positions <= its own; without one,
    causally over x itself."""
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
        out = cm.attention_over_cache(cfg, q, k, v, 0)
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


def block(cfg: ModelConfig, p: Block, x: torch.Tensor, positions: torch.Tensor,
          cache: Optional[KV] = None, pos: Optional[int] = None) -> torch.Tensor:
    h = cm.apply_norm(cfg, p.ln1, x)
    a = _attn(cfg, p, h, positions, cache, pos)
    if cfg.parallel_block:             # command-r: attention and MLP read one norm
        return x + a + _mlp(cfg, p.mlp, h)
    x = x + a
    return x + _mlp(cfg, p.mlp, cm.apply_norm(cfg, p.ln2, x))


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
    for layer in model.layers:
        x = block(cfg, layer, x, positions)
    x = cm.apply_norm(cfg, model.ln_f, x)
    return cm.logits_out(cfg, x, model.head())


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Dict]:
    """Shapes and dtypes of the KV cache: every layer attends in full, so one
    stacked `full` group of max_seq rows, keyed as the reference's tree."""
    check_supported(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"full": {name: (shape, cm.CACHE_DTYPE) for name in ("k", "v")}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """A zeroed cache of `cache_specs`' layout."""
    check_supported(cfg)
    return {"full": cm.kv_cache(cfg, cfg.num_layers, batch, max_seq, device)}


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, cache, tokens: torch.Tensor,
                pos: int):
    """tokens (B, S) at positions pos..pos+S-1 (S > 1 is a prefill); pos is
    the current cache length.  Returns (logits (B, S, V), cache): the new
    k/v are written into `cache` in place, and each token attends to the
    cached positions <= its own."""
    check_supported(cfg)
    x = _embed(cfg, model, tokens)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, pos, x.device)
    if cfg.rope == "learned":
        x = x + model.pos_embed[pos:pos + s][None].to(x.dtype)
    ck, cv = cache["full"]["k"], cache["full"]["v"]
    for li, layer in enumerate(model.layers):
        x = block(cfg, layer, x, positions, cache=(ck[li], cv[li]), pos=pos)
    x = cm.apply_norm(cfg, model.ln_f, x)
    return cm.logits_out(cfg, x, model.head()), cache

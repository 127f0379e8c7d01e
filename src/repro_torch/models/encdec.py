"""Whisper-style encoder-decoder (counterpart of `repro/models/encdec.py`).

The conv audio front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_seq, D) in place of the two-conv
mel-spectrogram stem.  The rest is the transformer's: sinusoidal encoder
positions, learned decoder positions (`pos_dec`), pre-norm blocks, GELU
MLPs, decoder self-attention and cross-attention, a tied head.  The
encoder's self-attention is causal, as the reference's (`cfg.causal`
reaches `attention_auto` through `transformer._attn`).

Decode keeps two caches: `self`, the decoder's KV cache appended at pos,
and `cross`, the encoder output's K/V for every decoder layer, computed
once (`init_cross_cache`) and read with causality off over all its rows.
Every attention goes through the flash kernel's dense mode.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.common import Norm, param

KV = Tuple[torch.Tensor, torch.Tensor]


class CrossAttn(nn.Module):
    """Cross-attention weights: q from the decoder, k/v from the encoder."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D, QD, KD = cfg.d_model, cfg.q_dim(), cfg.kv_dim()
        self.wq, self.wk, self.wv = param(D, QD, **kw), param(D, KD, **kw), param(D, KD, **kw)
        self.wo = param(QD, D, **kw)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = param(QD, **kw), param(KD, **kw), param(KD, **kw)


class DecBlock(tf.Block):
    """A decoder layer: self-attention, cross-attention and MLP, each pre-normed."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__(cfg, **kw)
        self.ln_x = Norm(cfg.d_model, cfg.norm == "layernorm" and cfg.norm_bias, **kw)
        self.cross = CrossAttn(cfg, **kw)


class EncDec(nn.Module):
    """The encoder-decoder's weights, named as the reference's tree
    (`enc_blocks.<path>[i]` is `enc_blocks.<i>.<path>`, and so for the
    decoder)."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=None):
        super().__init__()
        tf.check_supported(cfg)
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EncDec(device='cuda'): no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        kw = dict(device=device, dtype=dtype or getattr(torch, cfg.dtype))
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        bias = cfg.norm == "layernorm" and cfg.norm_bias
        self.embed = param(V, D, **kw)
        self.pos_dec = param(cfg.max_position, D, **kw)
        self.enc_blocks = nn.ModuleList(tf.Block(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.decoder_layers))
        self.ln_enc = Norm(D, bias, **kw)
        self.ln_f = Norm(D, bias, **kw)

    def init(self, generator: torch.Generator) -> "EncDec":
        """Random weights with the reference's initialisers (`encdec.specs`)."""
        return cm.init_weights(self, generator, ("gamma",), (),
                               {"embed": 0.02, "pos_dec": 0.02})


Model = EncDec


def _sinusoid(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


@torch.no_grad()
def encode(cfg: ModelConfig, model: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed frame embeddings (the conv stub)."""
    b, t, D = frames.shape
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) + torch.from_numpy(_sinusoid(t, D)).to(device=frames.device, dtype=dt)[None]
    positions = tf._positions(cfg, b, t, 0, x.device)
    for layer in model.enc_blocks:
        x = tf.block(cfg, layer, x, positions)
    return cm.apply_norm(cfg, model.ln_enc, x)


def _cross_attn(cfg: ModelConfig, p: CrossAttn, x, enc_kv: KV):
    """Cross-attention with precomputed encoder K/V (ck, cv)."""
    b, s, _ = x.shape
    q = cm.dense(cfg, x, p.wq, getattr(p, "bq", None)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = cm.cross_attention(cfg, q, *enc_kv)
    return cm.dense(cfg, out.reshape(b, s, cfg.q_dim()), p.wo)


def cross_kv(cfg: ModelConfig, model: EncDec, enc_out: torch.Tensor) -> KV:
    """Cross K/V of every decoder layer: (L, B, T_enc, Hkv, hd) each."""
    b, t, _ = enc_out.shape
    shape = (b, t, cfg.num_kv_heads, cfg.head_dim)
    ks, vs = [], []
    for layer in model.dec_blocks:
        p = layer.cross
        ks.append(cm.dense(cfg, enc_out, p.wk, getattr(p, "bk", None)).reshape(shape))
        vs.append(cm.dense(cfg, enc_out, p.wv, getattr(p, "bv", None)).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def init_cross_cache(cfg: ModelConfig, model: EncDec, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The `cross` cache of `frames`: the encoder, then every decoder layer's
    cross K/V, in bf16."""
    k, v = cross_kv(cfg, model, encode(cfg, model, frames))
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def _dec_layer(cfg: ModelConfig, p: DecBlock, x, positions, cross: KV,
               cache=None, pos=None):
    h = cm.apply_norm(cfg, p.ln1, x)
    x = x + tf._attn(cfg, p, h, positions, 0, cache, pos)
    hx = cm.apply_norm(cfg, p.ln_x, x)
    x = x + _cross_attn(cfg, p.cross, hx, cross)
    h2 = cm.apply_norm(cfg, p.ln2, x)
    return x + tf._mlp(cfg, p.mlp, h2)


def _head(cfg: ModelConfig, model: EncDec, x):
    return cm.logits_out(cfg, cm.apply_norm(cfg, model.ln_f, x), model.embed.T)


def _embed(cfg: ModelConfig, model: EncDec, tokens, pos: int):
    x = cm.embed(tokens, model.embed).to(getattr(torch, cfg.dtype))
    return x + model.pos_dec[pos:pos + tokens.shape[1]][None].to(x.dtype)


@torch.no_grad()
def decode_train(cfg: ModelConfig, model: EncDec, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass over tokens (B, S) -> logits (B, S, V)."""
    b, s = tokens.shape
    x = _embed(cfg, model, tokens, 0)
    positions = tf._positions(cfg, b, s, 0, x.device)
    ck, cv = cross_kv(cfg, model, enc_out)
    for li, layer in enumerate(model.dec_blocks):
        x = _dec_layer(cfg, layer, x, positions, (ck[li], cv[li]))
    return _head(cfg, model, x)


@torch.no_grad()
def apply(cfg: ModelConfig, model: EncDec, tokens: torch.Tensor, positions=None,
          extra_embeds=None) -> torch.Tensor:
    """The whole encoder-decoder forward: extra_embeds are the frame embeddings."""
    if extra_embeds is None:
        raise ValueError("encdec needs frame embeddings (extra_embeds)")
    return decode_train(cfg, model, tokens, encode(cfg, model, extra_embeds))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Dict]:
    """`self` (the decoder's KV cache, max_seq rows) and `cross` (encoder_seq
    rows), bf16, keyed as the reference's tree."""
    Ld = cfg.decoder_layers
    kv = lambda rows: {name: ((Ld, batch, rows, cfg.num_kv_heads, cfg.head_dim),  # noqa: E731
                              cm.CACHE_DTYPE) for name in ("k", "v")}
    return {"self": kv(max_seq), "cross": kv(cfg.encoder_seq)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """A zeroed cache of `cache_specs`' layout (the reference's server starts
    from a zero cross cache too; `init_cross_cache` fills it)."""
    return {"self": cm.kv_cache(cfg, cfg.decoder_layers, batch, max_seq, device),
            "cross": cm.kv_cache(cfg, cfg.decoder_layers, batch, cfg.encoder_seq, device)}


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: EncDec, cache, tokens: torch.Tensor, pos: int):
    """Decoder tokens (B, S) at positions pos..pos+S-1 -> (logits (B, S, V),
    cache): the self cache appended at pos in place, each token attending to
    the positions <= its own, and over every row of the cross cache."""
    b, s = tokens.shape
    x = _embed(cfg, model, tokens, pos)
    positions = tf._positions(cfg, b, s, pos, x.device)
    sk, sv, ck, cv = (cache["self"]["k"], cache["self"]["v"],
                      cache["cross"]["k"], cache["cross"]["v"])
    for li, layer in enumerate(model.dec_blocks):
        x = _dec_layer(cfg, layer, x, positions, (ck[li], cv[li]),
                       cache=(sk[li], sv[li]), pos=pos)
    return _head(cfg, model, x), cache

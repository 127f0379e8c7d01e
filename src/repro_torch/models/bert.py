"""BERT encoder (counterpart of `repro/models/bert.py`, bidirectional path).

Post-norm blocks, as in the paper's Table 1:
    X1 = MultiHeadAttention(X);      X2 = LayerNorm(X + X1)
    X3 = GELU(X2 W1 + b1);  X4 = X3 W2 + b2;  X5 = LayerNorm(X2 + X4)
Weights are held in cfg.dtype (the reference casts its float32 masters to
cfg.dtype once per call); the unused pooler is not carried.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm

LN_EPS = 1e-12


class Norm(nn.Module):
    def __init__(self, dim: int, bias: bool, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, **kw), requires_grad=False)
        if bias:
            self.beta = nn.Parameter(torch.zeros(dim, **kw), requires_grad=False)


def _param(*shape, **kw) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, **kw), requires_grad=False)


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

    def attn(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """`transformer._attn` without a cache: dense q/k/v, attention, dense out."""
        b, s, _ = x.shape
        q = cm.dense(cfg, x, self.wq, self.bq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = cm.dense(cfg, x, self.wk, self.bk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = cm.dense(cfg, x, self.wv, self.bv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        out = cm.attention_scores(cfg, q, k, v).reshape(b, s, cfg.q_dim())
        return cm.dense(cfg, out, self.wo)

    def mlp(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """`transformer._mlp`, plain type: GELU(x W1 + b1) W2 + b2."""
        h = cm.activation_fn(cfg, cm.dense(cfg, x, self.w1, self.b1))
        return cm.dense(cfg, h, self.w2, self.b2)

    def forward(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(cfg, self.ln1, x + self.attn(cfg, x), eps=LN_EPS)
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
        dev = generator.device
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf == "beta" or p.ndim == 1:
                p.zero_()
            else:
                scale = 0.02 if "embed" in leaf else p.shape[-2] ** -0.5
                w = torch.randn(p.shape, generator=generator, device=dev) * scale
                p.copy_(w)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


def _embed(cfg: ModelConfig, model: Bert, tokens: torch.Tensor) -> torch.Tensor:
    s = tokens.shape[1]
    x = cm.embed(tokens, model.embed)
    x = x + model.pos_embed[:s][None].to(x.dtype)
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

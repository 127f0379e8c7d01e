"""Shared model pieces (counterpart of `repro/models/common.py`): weights,
norms, projections, activations, RoPE and M-RoPE, attention, KV caches.

In NPE mode the 8-bit projections go through the MMU kernel, and the
softmax, the norms and the activations through the NVU kernels
(kernels/ops.py); on the CPU those wrappers run their plain versions.  The
16-bit MMU is fake-quantization with a float32 product, outside any kernel,
as in the reference.  Attention, over a KV cache (a full one or a
sliding-window ring) or over the sequence itself, causal or windowed, with or
without a logit soft cap, goes through the flash-attention kernel's dense
mode in every mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.core import nvu
from repro_torch.core.quant import dense_maybe_quant
from repro_torch.kernels import ops


def param(*shape, **kw) -> nn.Parameter:
    """A zeroed weight that takes no gradient (serving needs none; the
    trainer turns gradients on for its float32 masters)."""
    return nn.Parameter(torch.zeros(*shape, **kw), requires_grad=False)


class Norm(nn.Module):
    """A norm's weights: `gamma`, and `beta` with a bias."""

    def __init__(self, dim: int, bias: bool, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, **kw), requires_grad=False)
        if bias:
            self.beta = nn.Parameter(torch.zeros(dim, **kw), requires_grad=False)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator, ones=(), zeros=(),
                 scales=None) -> nn.Module:
    """Random weights with the reference's scales (`common._init_leaf`), by
    each parameter's last name: one for `ones`, zero for `zeros` and for the
    other vectors, normal x `scales[name]` where given, else normal x
    fan_in^-0.5 (fan_in the second-to-last axis).  Drawn in float32 on the
    generator's device one tensor at a time."""
    scales = scales or {}
    dev = generator.device
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ones:
            p.fill_(1.0)
        elif leaf in zeros or p.ndim == 1:
            p.zero_()
        else:
            scale = scales.get(leaf, p.shape[-2] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator, device=dev).mul_(scale))
    return model


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def layernorm_exact(x, gamma, beta=None, eps: float = 1e-6):
    """Float-mode LayerNorm with f32 statistics."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * gamma
    if beta is not None:
        y = y + beta
    return y.to(x.dtype)


def rmsnorm_exact(x, gamma, eps: float = 1e-6):
    """Float-mode RMSNorm: a bf16 x times the f32 1/sqrt promotes to f32, as
    in the reference, and the result is cast back to x's dtype."""
    ms = torch.square(x.to(torch.float32)).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def norm(cfg: ModelConfig, x, gamma, beta=None, eps: float = 1e-6):
    seg = cfg.npe_pwl_segments
    if cfg.norm == "layernorm":
        if cfg.npe_pwl:
            return ops.layernorm(x, gamma, beta, eps=eps, segments=seg)
        return layernorm_exact(x, gamma, beta, eps)
    if cfg.npe_pwl:
        return ops.rmsnorm(x, gamma, eps=eps, segments=seg)
    return rmsnorm_exact(x, gamma, eps)


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6):
    """`p` holds `gamma` and, with a bias, `beta` (a Norm module)."""
    return norm(cfg, x, p.gamma, getattr(p, "beta", None), eps=eps)


def dense(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All projections route here: float matmul, or the MMU.  The bias is
    added after the product is cast to x's dtype, as the reference does."""
    w = w.to(x.dtype)
    if cfg.npe_quant and cfg.npe_quant_bits == 8:
        y = ops.quant_dense(x, w)
    else:
        y = dense_maybe_quant(x, w, None, npe_quant=cfg.npe_quant,
                              bits=cfg.npe_quant_bits)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def activation_fn(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.npe_pwl:
        return ops.pwl_activation(x, cfg.activation, cfg.npe_pwl_segments)
    return nvu.activation(cfg.activation, False)(x)


def nonlinearity(cfg: ModelConfig, name: str, x: torch.Tensor, exact) -> torch.Tensor:
    """The NVU's `name` when cfg.npe_pwl (`ops.pwl_activation`; for exp and
    rsqrt `ops.pwl_exp` and `ops.pwl_rsqrt`), else `exact(x)`."""
    if not cfg.npe_pwl:
        return exact(x)
    if name in ("exp", "rsqrt"):
        return getattr(ops, f"pwl_{name}")(x, cfg.npe_pwl_segments)
    return ops.pwl_activation(x, name, cfg.npe_pwl_segments)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (B, S, H, D) by the f32 angles (B, S, D/2)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (B, S, 3) holds (t, h, w) ids; the D/2
    frequency slots are split into three sections, each rotated by its own
    position stream."""
    d2 = x.shape[-1] // 2
    sec = np.asarray(sections)
    sec = (sec * d2 / sec.sum()).astype(int)
    sec[-1] = d2 - sec[:-1].sum()
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    parts, start = [], 0
    for i, n in enumerate(sec):
        parts.append(positions3[..., i, None].to(torch.float32) * freqs[start:start + n])
        start += n
    return _rotate(x, torch.cat(parts, -1))


def attention_scores(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention with GQA.  q: (B, S, Hq, D); k, v: (B, S, Hkv, D).

    Scores are f32 (the operands are cast up, which is exact, so the product
    accumulates in f32 as the reference's preferred_element_type asks),
    times d**-0.5; the probabilities are cast to v's dtype for the second
    product.  In NPE mode the softmax kernel takes the scale and the cast:
    the same f32 multiply and the same rounding, in its one launch."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)      # b h g q d
    kh = k.permute(0, 2, 1, 3).unsqueeze(2)                       # b h 1 k d
    vh = v.permute(0, 2, 1, 3).unsqueeze(2)                       # b h 1 k d
    scores = torch.matmul(qg.to(torch.float32), kh.to(torch.float32).transpose(-1, -2))
    if cfg.npe_pwl:
        probs = ops.softmax(scores, segments=cfg.npe_pwl_segments, scale=d ** -0.5,
                            out_dtype=v.dtype)
    else:
        probs = torch.softmax(scores * (d ** -0.5), dim=-1).to(v.dtype)
    out = torch.matmul(probs, vh)                                 # b h g q d
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def attention_over_cache(cfg: ModelConfig, q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, pos: int, window: int = 0,
                         ring: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q (B, S, Hq, D), at positions pos..pos+S-1, over a
    (B, max_seq, Hkv, D) cache that holds the keys and values of positions
    < pos + S: the cache case of the reference's `attention_scores`
    (q_offset=pos), one softmax over every visible key, the probabilities
    rounded to the cache's dtype before P.V.  With `window` > 0 a query sees
    only the keys after its position - window.  With `ring` (S = 1), the
    cache is a sliding-window ring of `ring` rows written at pos % ring, and
    the query sees every written row with causality off: the reference's
    `kv_valid = arange(ring) <= pos | pos >= ring`, a prefix of
    min(pos + 1, ring) rows.  cfg.logit_softcap > 0 soft-caps the scores.

    The flash kernel's dense mode reads the cache in place through permuted
    views, and of it only the keys some query of a block can see; PWL exp,
    reciprocal and tanh when cfg.npe_pwl.  The result is (B, S, Hq, D) in the
    cache's dtype, as the reference's P.V gives it.  With pos = 0 and the sequence's
    own k and v as the "cache", this is causal (or windowed) self-attention:
    the reference's `attention_auto`, whose query chunks past 2048 rows
    bound the memory of its (Sq, Skv) scores; the dense mode keeps no such
    tensor, so it takes every length in one launch and gives the same
    function.  On the card the dense mode takes bf16 k and v only."""
    s = q.shape[1]
    if ring is not None and s != 1:
        raise ValueError(f"attention_over_cache: {s} queries over a ring cache; a ring "
                         "is written one token at a time")
    kv_len = pos + s if ring is None else min(pos + 1, ring)
    out = ops.dense_attention(q.permute(0, 2, 1, 3), cache_k.permute(0, 2, 1, 3),
                              cache_v.permute(0, 2, 1, 3), kv_len=kv_len,
                              causal=ring is None, window=window,
                              softcap=cfg.logit_softcap, use_pwl=cfg.npe_pwl,
                              segments=cfg.npe_pwl_segments, out_dtype=cache_v.dtype)
    return out.permute(0, 2, 1, 3)


def cross_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, S, Hq, D) over every row of k, v (B, T, Hkv, D)
    with causality off (S <= T): the reference's `attention_scores(causal=
    False)`, Whisper's cross-attention over the encoder's rows, through the
    flash kernel's dense mode.  The result is in v's dtype, as the
    reference's P.V gives it."""
    out = ops.dense_attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), kv_len=k.shape[1], causal=False,
                              softcap=cfg.logit_softcap, use_pwl=cfg.npe_pwl,
                              segments=cfg.npe_pwl_segments, out_dtype=v.dtype)
    return out.permute(0, 2, 1, 3)


def logits_out(cfg: ModelConfig, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Final projection with a (D, V) table."""
    return dense(cfg, x, table)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_true: Optional[int] = None) -> torch.Tensor:
    """Mean cross entropy in float32; labels < 0 (ignore ids) or >=
    vocab_true (padding ids) are masked out."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(labels, 0, logits.shape[-1] - 1).to(torch.int64)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = logz - ll
    valid = labels >= 0
    if vocab_true is not None:
        valid = valid & (labels < vocab_true)
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------

CACHE_DTYPE = torch.bfloat16     # the reference's kv_cache_specs default


def kv_cache(cfg: ModelConfig, layers: int, batch: int, max_seq: int,
             device) -> Dict[str, torch.Tensor]:
    """Zeroed k and v caches, (layers, batch, max_seq, Hkv, Dh) in bf16 (the
    reference keeps them in bf16 whatever the model's dtype)."""
    shape = (layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=CACHE_DTYPE, device=device)
            for name in ("k", "v")}


def update_cache_layer(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B, S_new, H, D) at time offset `pos` (a ring cache's pos % its
    length), in place (the reference returns updated copies), cast to the
    cache's dtype."""
    s = k_new.shape[1]
    if not 0 <= pos <= cache_k.shape[1] - s:
        raise ValueError(f"update_cache_layer: {s} rows at {pos} in a cache of "
                         f"{cache_k.shape[1]}")
    cache_k[:, pos:pos + s] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + s] = v_new.to(cache_v.dtype)
    return cache_k, cache_v

"""RWKV6 "Finch" (counterpart of `repro/models/rwkv6.py`): an attention-free
RNN with data-dependent decay.

Token-shift ddlerp mixing with a low-rank (LoRA) data-dependent
interpolation, a per-channel decay w_t = exp(-exp(.)), a per-head matrix
state S (N x N), the bonus u for the current token, a per-head group norm
and squared-ReLU channel mixing.

NPE mode: the projections go through the MMU (`cm.dense`, `cm.logits_out`);
tanh, silu, sigmoid, the composite decay exp(-exp(x)) and the group norm's
1/sqrt through the PWL kernel (`ops.pwl_activation`, `ops.pwl_rsqrt`), the
LayerNorms through
the layernorm kernel; ReLU^2 is max and multiply.  The LoRA products stay
`torch.matmul` / `einsum`, as the reference computes them outside
`cm.dense`.  The group norm stays torch ops (its mean and variance over a
head, eps 64e-5 after the variance), since the layernorm kernel adds in
another order.

The recurrence is a Python loop over time on a float32 state, as the
reference's `lax.scan` step; its chunked checkpointing serves only training
memory and is not ported.  Weights are held in cfg.dtype (the reference
casts every float parameter to cfg.dtype once per call).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import Norm, param

LORA_R = 32
DECAY_R = 64           # rank of the decay's LoRA (w_lora_a / w_lora_b)
ONES = ("gamma", "gn_gamma")
ZEROS = ("mu", "lora_b", "w_lora_b", "u")      # with every vector
SCALES = {"embed": 0.02, "lora_a": 0.01, "w_lora_a": 0.01}


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    N = cfg.ssm.head_size if cfg.ssm else 64
    return cfg.d_model // N, N


class Mix(nn.Module):
    """ddlerp weights of the five streams (w, k, v, r, g)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D = cfg.d_model
        self.mu, self.mu_x = param(5, D, **kw), param(D, **kw)
        self.lora_a, self.lora_b = param(5, D, LORA_R, **kw), param(5, LORA_R, D, **kw)


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D = cfg.d_model
        H, N = _heads(cfg)
        self.mix = Mix(cfg, **kw)
        self.w0 = param(D, **kw)
        self.w_lora_a, self.w_lora_b = param(D, DECAY_R, **kw), param(DECAY_R, D, **kw)
        self.u = param(H, N, **kw)
        self.wr, self.wk, self.wv = param(D, D, **kw), param(D, D, **kw), param(D, D, **kw)
        self.wg, self.wo = param(D, D, **kw), param(D, D, **kw)
        self.gn_gamma, self.gn_beta = param(D, **kw), param(D, **kw)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.mu_k, self.mu_r = param(D, **kw), param(D, **kw)
        self.wk, self.wv, self.wr = param(D, F, **kw), param(F, D, **kw), param(D, D, **kw)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, True, **kw)
        self.ln2 = Norm(cfg.d_model, True, **kw)
        self.att = TimeMix(cfg, **kw)
        self.ffn = ChannelMix(cfg, **kw)


class RWKV6(nn.Module):
    """RWKV6's weights, named as the reference's parameter tree (`blocks.<path>`
    is `layers.<i>.<path>`)."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=None):
        super().__init__()
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RWKV6(device='cuda'): no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        kw = dict(device=device, dtype=dtype or getattr(torch, cfg.dtype))
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = param(V, D, **kw)
        self.ln_in = Norm(D, True, **kw)
        self.ln_f = Norm(D, True, **kw)
        self.lm_head = param(D, V, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))

    def init(self, generator: torch.Generator) -> "RWKV6":
        """Random weights with the reference's initialisers (`rwkv6.specs`)."""
        return cm.init_weights(self, generator, ONES, ZEROS, SCALES)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, self, tokens)


Model = RWKV6


def _sigmoid(cfg, x):
    return cm.nonlinearity(cfg, "sigmoid", x, torch.sigmoid)


def _tanh(cfg, x):
    return cm.nonlinearity(cfg, "tanh", x, torch.tanh)


def _silu(cfg, x):
    return cm.nonlinearity(cfg, "silu", x, F.silu)


def _relu2(cfg, x):
    return cm.nonlinearity(cfg, "relu2", x, lambda t: torch.square(torch.relu(t)))


def _decay(cfg, x):
    """w = exp(-exp(x)) in (0, 1): the data-dependent decay."""
    return cm.nonlinearity(cfg, "exp_neg_exp", x,
                lambda t: torch.exp(-torch.exp(torch.clamp(t, -40.0, 10.0))))


def _rsqrt(cfg, x):
    return cm.nonlinearity(cfg, "rsqrt", x, torch.rsqrt)


def _layernorm(cfg: ModelConfig, x, p: Norm):
    """LayerNorm with eps 1e-5 (cfg.norm is "layernorm"): the NVU's, or exact
    with f32 statistics."""
    return cm.norm(cfg, x, p.gamma, p.beta, eps=1e-5)


def _groupnorm_heads(cfg: ModelConfig, x, gamma, beta, H: int, N: int):
    """Per-head group norm of (B, T, D) viewed as (B, T, H, N), in float32."""
    b, t, D = x.shape
    xh = x.reshape(b, t, H, N).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = torch.square(xh - mu).mean(-1, keepdim=True)
    inv = _rsqrt(cfg, var + 64e-5)
    xn = ((xh - mu) * inv).reshape(b, t, D)
    return (xn * gamma + beta).to(x.dtype)


def _ddlerp(cfg: ModelConfig, p: Mix, x, x_prev):
    """Data-dependent token-shift mixing -> 5 streams (w, k, v, r, g)."""
    dx = x_prev - x
    xx = x + dx * p.mu_x
    lora = torch.einsum("btd,ndr->btnr", _tanh(cfg, xx), p.lora_a.to(x.dtype))
    lora = torch.einsum("btnr,nrd->btnd", lora, p.lora_b.to(x.dtype))
    mixed = x[:, :, None] + dx[:, :, None] * (p.mu + lora)
    return [mixed[:, :, i] for i in range(5)]


def _time_mix(cfg: ModelConfig, p: TimeMix, x, x_prev, state):
    """One layer's WKV6 over a sequence.  x: (B, T, D); x_prev: (B, D);
    state: (B, H, N, N) float32.  Returns (out, new x_prev, new state)."""
    H, N = _heads(cfg)
    b, t, D = x.shape
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(cfg, p.mix, x, shifted)
    r = cm.dense(cfg, xr, p.wr).reshape(b, t, H, N)
    k = cm.dense(cfg, xk, p.wk).reshape(b, t, H, N)
    v = cm.dense(cfg, xv, p.wv).reshape(b, t, H, N)
    g = _silu(cfg, cm.dense(cfg, xg, p.wg))
    wx = p.w0 + _tanh(cfg, xw @ p.w_lora_a.to(x.dtype)) @ p.w_lora_b.to(x.dtype)
    w = _decay(cfg, wx).reshape(b, t, H, N)                 # in (0, 1)
    u = p.u[..., None]                                      # (H, N, 1)
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]      # (B, H, N, N)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, i].to(torch.float32),
                                 state + u * kv))
        state = w[:, i, :, :, None] * state + kv
    out = torch.stack(outs, dim=1).reshape(b, t, D).to(x.dtype)
    out = _groupnorm_heads(cfg, out, p.gn_gamma, p.gn_beta, H, N)
    out = cm.dense(cfg, out * g, p.wo)
    return out, x[:, -1], state


def _channel_mix(cfg: ModelConfig, p: ChannelMix, x, x_prev):
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    dx = shifted - x
    xk = x + dx * p.mu_k
    xr = x + dx * p.mu_r
    k = _relu2(cfg, cm.dense(cfg, xk, p.wk))
    kv = cm.dense(cfg, k, p.wv)
    return _sigmoid(cfg, cm.dense(cfg, xr, p.wr)) * kv, x[:, -1]


def _embed(cfg: ModelConfig, model: RWKV6, tokens):
    x = cm.embed(tokens, model.embed).to(getattr(torch, cfg.dtype))
    return _layernorm(cfg, x, model.ln_in)


def _head(cfg: ModelConfig, model: RWKV6, x):
    return cm.logits_out(cfg, _layernorm(cfg, x, model.ln_f), model.lm_head)


@torch.no_grad()
def apply(cfg: ModelConfig, model: RWKV6, tokens: torch.Tensor, positions=None,
          extra_embeds=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), every layer from a zero state."""
    H, N = _heads(cfg)
    x = _embed(cfg, model, tokens)
    b, t, D = x.shape
    for layer in model.layers:
        h = _layernorm(cfg, x, layer.ln1)
        state0 = torch.zeros((b, H, N, N), dtype=torch.float32, device=x.device)
        att, _, _ = _time_mix(cfg, layer.att, h, h.new_zeros((b, D)), state0)
        x = x + att
        h2 = _layernorm(cfg, x, layer.ln2)
        ffn, _ = _channel_mix(cfg, layer.ffn, h2, h2.new_zeros((b, D)))
        x = x + ffn
    return _head(cfg, model, x)


# --- decode -----------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Tuple]:
    """O(1) recurrent state, no KV cache: each layer's float32 WKV state and
    the last input of its time mix and channel mix (cfg.dtype), keyed as
    the reference's tree."""
    H, N = _heads(cfg)
    L, D = cfg.num_layers, cfg.d_model
    dt = getattr(torch, cfg.dtype)
    return {"state": ((L, batch, H, N, N), torch.float32),
            "x_att": ((L, batch, D), dt), "x_ffn": ((L, batch, D), dt)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A zeroed state of `cache_specs`' layout."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_specs(cfg, batch, max_seq).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: RWKV6, cache, tokens: torch.Tensor, pos: int):
    """tokens (B, S) -> (logits (B, S, V), cache): the state advances S steps,
    written into `cache`'s tensors in place (a slot's view writes through).
    `pos` is unused: the state carries the position."""
    x = _embed(cfg, model, tokens)
    for i, layer in enumerate(model.layers):
        st, xa, xf = cache["state"][i], cache["x_att"][i], cache["x_ffn"][i]
        h = _layernorm(cfg, x, layer.ln1)
        att, new_xa, new_st = _time_mix(cfg, layer.att, h, xa, st)
        x = x + att
        h2 = _layernorm(cfg, x, layer.ln2)
        ffn, new_xf = _channel_mix(cfg, layer.ffn, h2, xf)
        x = x + ffn
        st.copy_(new_st)
        xa.copy_(new_xa)
        xf.copy_(new_xf)
    return _head(cfg, model, x), cache

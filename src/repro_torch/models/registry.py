"""Model family registry (counterpart of `repro/models/registry.py`): every
family of the reference, BERT (models/bert.py), the dense, vlm and moe
decoders (models/transformer.py), RWKV6 (`ssm`, models/rwkv6.py), the
attention + Mamba hybrid (models/hybrid.py) and the encoder-decoder
(models/encdec.py)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import bert as bert_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import rwkv6 as rwkv6_mod
from repro_torch.models import transformer as tf

_FAMILIES = {
    "dense": tf,
    "moe": tf,
    "vlm": tf,
    "ssm": rwkv6_mod,
    "hybrid": hybrid_mod,
    "encdec": encdec_mod,
    "bert": bert_mod,
}


def module_for(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}; have {sorted(_FAMILIES)}") from None


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None, dtype=None):
    """The family's model of `cfg` on `device` (weights in cfg.dtype unless
    `dtype`), with random weights drawn from `generator` when one is given."""
    model = module_for(cfg).Model(cfg, device=device, dtype=dtype)
    return model if generator is None else model.init(generator)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    """A model of `cfg` with float32 master weights (the reference's
    `RunConfig.param_dtype`) drawn from `generator`, for training: BERT or
    a decoder, whose `forward_train` casts them to cfg.dtype each call."""
    return build_model(cfg, device=device, generator=generator, dtype=dtype)


# What each family lacks before it can train.  BERT, the dense and vlm
# decoders and the MoE decoders train: the port's backward passes cover the
# kernels on their paths (quant_matmul, nvu_softmax, nvu_layernorm,
# pwl_eval and flash attention's dense mode) and the torch ops around them,
# MoE routing's gates included.
TRAIN_MISSING = {
    "ssm": "the backward of the RWKV6 recurrence (its time-mix loop over the sequence)",
    "hybrid": "the backward of the Mamba recurrence (the selective scan of its SSM head)",
    "encdec": "the encoder-decoder's training forward and batch (audio frames beside the "
              "tokens), and its trainer path",
}


def require_trainable(cfg: ModelConfig) -> None:
    """BERT and the dense, vlm and moe decoders train; every other family
    raises NotImplementedError naming what it lacks."""
    if cfg.family in TRAIN_MISSING or cfg.family not in _FAMILIES:
        missing = TRAIN_MISSING.get(cfg.family, "a training forward")
        raise NotImplementedError(f"training {cfg.name} ({cfg.family}) needs {missing}, "
                                  "which the port does not have yet")


def train_apply(cfg: ModelConfig, model, tokens, remat: bool = True, extra_embeds=None):
    """Logits with gradients for training (`require_trainable`): BERT's MLM
    logits, or a decoder's (with extra_embeds, the vlm's patches ahead of
    the tokens, their logits included)."""
    require_trainable(cfg)
    if cfg.family == "bert":
        if extra_embeds is not None:
            raise ValueError("train_apply: BERT takes no extra embeddings")
        return bert_mod.forward_train(cfg, model, tokens, remat=remat)
    return tf.forward_train(cfg, model, tokens, remat=remat, extra_embeds=extra_embeds)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the port's model, counted on the meta device (no memory)."""
    return sum(p.numel() for p in build_model(cfg, device="meta").parameters())


def apply(cfg: ModelConfig, model, tokens, **kw):
    return module_for(cfg).apply(cfg, model, tokens, **kw)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    return module_for(cfg).cache_specs(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    return module_for(cfg).init_cache(cfg, batch, max_seq, device)


def decode_step(cfg: ModelConfig, model, cache, tokens, pos: int):
    return module_for(cfg).decode_step(cfg, model, cache, tokens, pos)


def has_decode(cfg: ModelConfig) -> bool:
    return hasattr(module_for(cfg), "decode_step")

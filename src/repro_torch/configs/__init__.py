"""Architecture registry (counterpart of `repro/configs/__init__.py`).

The port carries the configurations it runs: the paper's BERT, the dense
and vlm decoders (glm4_9b, command_r_plus_104b, qwen2_vl_7b; starcoder2_3b's
sliding window and gemma3_27b's local:global layers) and the MoE decoders
(granite_moe_1b_a400m, llama4_maverick_400b_a17b), RWKV6 (rwkv6_3b), the
attention + Mamba hybrid (hymba_1_5b) and the encoder-decoder
(whisper_base): all 11 of the reference.  Each records its public source
and pads the vocabulary as the reference does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "command_r_plus_104b",
    "starcoder2_3b",
    "gemma3_27b",
    "glm4_9b",
    "qwen2_vl_7b",
    "granite_moe_1b_a400m",
    "llama4_maverick_400b_a17b",
    "rwkv6_3b",
    "hymba_1_5b",
    "whisper_base",
    "bert_base",
]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config() if smoke else mod.config()


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple of `multiple` unless it divides by 16."""
    if v % 16 == 0:
        return v
    return -(-v // multiple) * multiple


def shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU tests: few layers, narrow width,
    tiny vocab, the reference's fields.  With num_heads=4 and num_kv_heads=2
    the smoke model is GQA."""
    d = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=64 if cfg.moe else 256,
        vocab_size=512,
        max_position=4096,
        window=min(cfg.window, 32),
        global_every=2 if cfg.attention == "local_global" else cfg.global_every,
        encoder_layers=min(cfg.encoder_layers, 2),
        decoder_layers=min(cfg.decoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64),
        num_patches=min(cfg.num_patches, 16),
    )
    if cfg.moe:
        d["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2))
    d.update(over)
    return dataclasses.replace(cfg, **d)

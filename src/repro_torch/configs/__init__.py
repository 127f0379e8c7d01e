"""Architecture registry (counterpart of `repro/configs/__init__.py`).

The port carries the configurations it runs: so far the paper's BERT.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = ["bert_base"]


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
    tiny vocab.  With num_heads=4 and num_kv_heads=2 the smoke model is GQA."""
    d = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_position=4096,
        window=min(cfg.window, 32),
    )
    d.update(over)
    return dataclasses.replace(cfg, **d)

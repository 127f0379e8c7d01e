"""Model family registry (counterpart of `repro/models/registry.py`).

The port carries one family so far, BERT; every other family of the
reference raises until it is ported.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import bert as bert_mod

_FAMILIES = {"bert": bert_mod}


def module_for(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"family {cfg.family!r} is not ported; have "
                         f"{sorted(_FAMILIES)}") from None


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    return module_for(cfg).cache_specs(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    return module_for(cfg).init_cache(cfg, batch, max_seq, device)


def decode_step(cfg: ModelConfig, model, cache, tokens, pos: int):
    return module_for(cfg).decode_step(cfg, model, cache, tokens, pos)

"""Batched KV-cache decode serving (counterpart of the jnp backend of
`repro/launch/serve.py`: `ServeStats`, `Server` and its CLI).

A fixed pool of B decode slots.  Each prompt is prefilled alone, by one
multi-token `decode_step` at position 0 on its slot's slice of the cache;
then every slot decodes one greedy token a step on one common position
clock that starts at the longest prompt's length.  As in the reference, a
slot with a shorter prompt attends over the zero cache rows between its
length and that start, and each slot's last prompt token is fed again at
the start.  Every attention goes through the flash-attention kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --max-seq 256 \
        --gen 64 --mode npe-8bit

prints the prefill ms per slot, the ms per decode step and tokens/s on the
card, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.launch.serve_bert import MODES, card_info
from repro_torch.launch.steps import build_decode_step
from repro_torch.models import registry
from repro_torch.models.bert import Bert


@dataclass
class ServeStats:
    latencies_ms: List[float] = field(default_factory=list)   # prefill, per slot
    step_ms: List[float] = field(default_factory=list)        # per decode step
    tokens: int = 0
    wall: float = 0.0
    generated: Optional[np.ndarray] = None                    # (B, gen) token ids

    def report(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies_ms)
        steps = np.asarray(self.step_ms)
        return {
            "requests": len(lat),
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) if len(lat) else 0.0,
            "prefill_ms_per_slot": float(lat.mean()) if len(lat) else 0.0,
            "decode_ms_per_step": float(np.median(steps)) if len(steps) else 0.0,
            "tokens_per_sec": self.tokens / max(self.wall, 1e-9),
        }


class Server:
    """Decode-slot server for BERT in one mode (float, NPE-8 or NPE-16).

    `model` shares weights between servers; without it the server draws
    random weights from `seed` on its device.  Full width unless `smoke`."""

    def __init__(self, arch: str = "bert_base", batch: int = 4, max_seq: int = 128,
                 mode: str = "float", device="cuda", model: Optional[Bert] = None,
                 seed: int = 0, smoke: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server: no CUDA device; pass device='cpu' to serve "
                               "on the CPU")
        if mode not in MODES:
            raise KeyError(f"unknown mode {mode!r}; have {sorted(MODES)}")
        cfg = get_config(arch, smoke=smoke)
        if max_seq > cfg.max_position:
            raise ValueError(f"max_seq {max_seq} > max_position {cfg.max_position}")
        self.cfg = MODES[mode](cfg)
        self.batch, self.max_seq, self.device = batch, max_seq, device
        if model is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            model = Bert(cfg, device=device).init(gen)
        self.model = model
        self.decode = build_decode_step(self.cfg)
        self.cache = registry.init_cache(self.cfg, batch, max_seq, device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill one slot: the whole prompt through `decode_step` at
        positions 0..S-1 on this slot's slice of the cache (a view, written
        in place)."""
        sub = {"full": {k: c[:, slot:slot + 1] for k, c in self.cache["full"].items()}}
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=self.device)[None]
        registry.decode_step(self.cfg, self.model, sub, toks, 0)

    def generate(self, prompts: Sequence[np.ndarray], gen_tokens: int = 8) -> ServeStats:
        """Prefill each slot, then `gen_tokens` greedy steps for all slots.
        Host clock: each prefill and each step ends in a synchronize."""
        stats = ServeStats()
        t_all = time.perf_counter()
        start = max(len(p) for p in prompts)    # common position clock
        if start + gen_tokens > self.max_seq:
            raise ValueError(f"{start} + {gen_tokens} tokens exceed max_seq {self.max_seq}")
        toks = np.zeros((self.batch, 1), np.int64)
        for slot, p in enumerate(prompts[: self.batch]):
            t0 = time.perf_counter()
            self.prefill_prompt(slot, p)
            self._sync()
            toks[slot, 0] = p[-1]
            stats.latencies_ms.append(1e3 * (time.perf_counter() - t0))
        cur = torch.as_tensor(toks, device=self.device)
        out = []
        for i in range(gen_tokens):
            t0 = time.perf_counter()
            cur, self.cache = self.decode(self.model, self.cache, cur, start + i)
            self._sync()
            stats.step_ms.append(1e3 * (time.perf_counter() - t0))
            out.append(cur)
            stats.tokens += self.batch
        stats.wall = time.perf_counter() - t_all
        stats.generated = torch.cat(out, dim=1).cpu().numpy()
        return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="bert_base")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-prompt", type=int, default=128)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--mode", default="npe-8bit", choices=sorted(MODES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device")
    card = card_info()
    srv = Server(args.arch, batch=args.batch, max_seq=args.max_seq, mode=args.mode,
                 seed=args.seed)
    reqs = SyntheticRequests(srv.cfg.vocab_size, max_prompt=args.max_prompt)
    prompts = [reqs.request(i) for i in range(args.batch)]
    srv.generate(prompts, gen_tokens=2)          # warm-up: builds the kernels
    srv.cache = registry.init_cache(srv.cfg, args.batch, args.max_seq, srv.device)
    rep = srv.generate(prompts, gen_tokens=args.gen).report()
    print(f"card: {card}")
    print(f"{args.mode}: prefill {rep['prefill_ms_per_slot']:.3f} ms per slot, "
          f"decode {rep['decode_ms_per_step']:.3f} ms per step (median), "
          f"{rep['tokens_per_sec']:.1f} tokens/s, batch {args.batch}, "
          f"max_seq {args.max_seq}, on {card}")
    print("serve OK")


if __name__ == "__main__":
    main()

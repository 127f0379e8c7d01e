"""BERT encoder serving on the card (counterpart of `examples/serve_bert.py`).

`BertServer` answers batches of token-id requests with MLM logits and top-1
ids, in float, NPE-8 or NPE-16 mode.  The CLI serves a few batches in all
three modes on one set of random weights and prints ms/batch on the card,
with the card's name and power limit, and top-1 agreement with float:

    PYTHONPATH=src python -m repro_torch.launch.serve_bert --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.models import bert
from repro_torch.models.bert import Bert

MODES = {
    "float": lambda c: c,
    "npe-8bit": lambda c: c.with_npe(quant_bits=8, segments=16),
    "npe-16bit": lambda c: c.with_npe(quant_bits=16, segments=16),
}


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class BertServer:
    """Batched BERT encoder inference in one NPE mode.

    `model` shares weights between servers of different modes; without it
    the server draws random weights from `seed` on its device."""

    def __init__(self, cfg: Optional[ModelConfig] = None, mode: str = "npe-8bit",
                 seq: int = 128, device="cuda", dtype: Optional[torch.dtype] = None,
                 model: Optional[Bert] = None, seed: int = 0):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BertServer: no CUDA device; pass device='cpu' to "
                               "serve on the CPU")
        if mode not in MODES:
            raise KeyError(f"unknown mode {mode!r}; have {sorted(MODES)}")
        cfg = cfg or get_config("bert_base")
        if seq > cfg.max_position:
            raise ValueError(f"seq {seq} > max_position {cfg.max_position}")
        self.cfg = MODES[mode](cfg)
        self.seq = seq
        self.device = device
        if model is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            model = Bert(cfg, device=device, dtype=dtype).init(gen)
        self.model = model

    def tokens(self, requests: Sequence[np.ndarray]) -> torch.Tensor:
        """Zero-pad (or cut) each request to `seq` tokens: (B, seq) ids."""
        batch = np.zeros((len(requests), self.seq), np.int64)
        for i, r in enumerate(requests):
            r = np.asarray(r)[: self.seq]
            batch[i, : len(r)] = r
        return torch.from_numpy(batch).to(self.device)

    def answer(self, requests: Sequence[np.ndarray]):
        """Logits (B, seq, V) and top-1 ids (B, seq) for a batch of requests."""
        logits = bert.apply(self.cfg, self.model, self.tokens(requests))
        return logits, logits.argmax(-1)


def serve(batch: int, seq: int, batches: int, seed: int = 0, device="cuda",
          cfg: Optional[ModelConfig] = None):
    """Serve `batches` batches of synthetic requests in each mode, on one set
    of weights.  Returns ({mode: (ms/batch, top-1 agreement with float)},
    {mode: server}, the batches of requests)."""
    float_server = BertServer(cfg, mode="float", seq=seq, device=device, seed=seed)
    reqs = SyntheticRequests(float_server.cfg.vocab_size, max_prompt=seq, seed=1)
    work = [[reqs.request(b * batch + i) for i in range(batch)]
            for b in range(batches)]
    results, servers, ref_top1 = {}, {}, None
    for mode in MODES:
        server = servers[mode] = BertServer(cfg, mode=mode, seq=seq, device=device,
                                            model=float_server.model)
        server.answer(work[0])                              # warm-up
        if server.device.type == "cuda":
            torch.cuda.synchronize()
        top1, t0 = [], time.perf_counter()
        for reqs_b in work:
            top1.append(server.answer(reqs_b)[1])
        if server.device.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / batches
        top1 = torch.stack(top1)
        ref_top1 = top1 if ref_top1 is None else ref_top1
        results[mode] = (ms, float((top1 == ref_top1).float().mean()))
    return results, servers, work


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_bert: no CUDA device")
    card = card_info()
    print(f"card: {card}")
    results, _, _ = serve(args.batch, args.seq, args.batches, args.seed)
    for mode, (ms, agree) in results.items():
        print(f"{mode:10s}: {ms:8.3f} ms/batch of {args.batch}x{args.seq} on "
              f"{card}, top-1 agreement vs float: {agree:.4f}")


if __name__ == "__main__":
    main()

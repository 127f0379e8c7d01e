"""NPE logits' correlation with float at a model's full width and depth, the
card's kernel route beside the port's plain route on the CPU, on the same
weights.

    PYTHONPATH=src python3 scripts/card_cpu_depth.py [--arch rwkv6_3b] [--layers 32]

Builds `--arch` at its full width and `--layers` layers (the config's depth
by default) in its own dtype, with random weights drawn on the CPU from
`--seed`, and runs the forward (`registry.apply`) of 8 seeded prompts cut
to their shortest length (chip_smoke.py's measure in [12] and [13]) in
float, NPE-8 and NPE-16: first on the CPU, where every wrapper runs its
plain version, then with the same weights on the card, through the
kernels.  It prints each route's correlation of each NPE mode's logits with
its own float logits, and the two routes' largest logit difference and
top-1 agreement in each mode; and, as the yardstick of how far bf16
roundings alone carry two runs apart at that depth, the same two numbers
between the CPU's float logits and those of a float32 copy of the same
weights on the CPU, and between the card's and the float32 copy's.  It
answers whether a low correlation at depth on the card comes from the
card's route (a fault of its glue) or is there in the plain route too.
Needs a CUDA card, and host memory for three copies of the weights.
"""
import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.launch.serve_bert import MODES
from repro_torch.models import registry

PROMPTS, MAX_PROMPT = 8, 16


def forward_logits(cfg, model, tokens):
    """Each mode's logits (float32, on the CPU) of the forward of `tokens`."""
    return {mode: registry.apply(MODES[mode](cfg), model, tokens).float().cpu()
            for mode in ("float", "npe-8bit", "npe-16bit")}


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])


def apart(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Largest difference and top-1 agreement of two runs' logits."""
    return dict(max_abs=float((a - b).abs().max()),
                top1=float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("card_cpu_depth: no CUDA device", file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=MAX_PROMPT, seed=1)
    prompts = [reqs.request(i) for i in range(PROMPTS)]
    n = min(map(len, prompts))
    tokens = torch.as_tensor(np.stack([p[:n] for p in prompts])).long()
    t0 = time.perf_counter()
    cpu_model = registry.build_model(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(args.seed))
    print(f"{args.arch}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.dtype}, "
          f"{sum(p.numel() for p in cpu_model.parameters()):,} parameters; "
          f"{PROMPTS} x {n} tokens", flush=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32_model = registry.build_model(cfg32, device="cpu")
    f32_model.load_state_dict(cpu_model.state_dict())
    with torch.no_grad():
        plain = forward_logits(cfg, cpu_model, tokens)
        f32 = registry.apply(cfg32, f32_model, tokens).float()
    del f32_model
    t_cpu = time.perf_counter() - t0
    card_model = registry.build_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    del cpu_model
    t1 = time.perf_counter()
    with torch.no_grad():
        card = forward_logits(cfg, card_model, tokens.to(dev))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    out = dict(arch=args.arch, layers=cfg.num_layers, tokens=[PROMPTS, n],
               cpu_seconds=t_cpu, card_seconds=t_card, modes={},
               float32_copy=dict(cpu=apart(plain["float"], f32), card=apart(card["float"], f32)))
    for mode in plain:
        d = apart(card[mode], plain[mode])
        row = out["modes"][mode] = dict(card_vs_cpu_max_abs=d["max_abs"],
                                        card_vs_cpu_top1=d["top1"],
                                        finite=bool(torch.isfinite(card[mode]).all()))
        if mode != "float":
            row.update(corr_with_float_cpu=corr(plain[mode], plain["float"]),
                       corr_with_float_card=corr(card[mode], card["float"]))
        print(f"  {mode:10s} " + ", ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
            flush=True)
    for route, d in out["float32_copy"].items():
        print(f"  float, {route} (its dtype) vs a float32 copy on the CPU: max-abs "
              f"{d['max_abs']:.5f}, top-1 {d['top1']:.5f}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

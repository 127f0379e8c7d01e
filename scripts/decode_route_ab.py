"""Host ms of a one-slot prefill and of a decode step through the decode
path's dense attention and through the blocked flash route, in turns, in one
process.

    python3 scripts/decode_route_ab.py

Full-width BERT-base in NPE-8 through `launch.serve.Server` (8 slots, a
256-row cache, the prompts of `chip_smoke.py` [5]).  Six rounds alternate
which route runs first; each round prefills every slot alone and takes 8
steps, each timed on the host clock up to a synchronize.  Prints the median
and quartiles of each, then the device busy ms and launches of one prefill of
each route by torch.profiler.  Two serving runs of `chip_smoke.py` land on
hosts that differ by more than either route; this compares them on one.
Needs the card.
"""
import contextlib
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import BlockedAttention, _kernel_times, card_info, decode_prompts  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROUNDS, STEPS = 6, 8


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def spread(v):
    v = sorted(v)
    return f"median {statistics.median(v):.3f} (quartiles {v[len(v) // 4]:.3f}, " \
           f"{v[3 * len(v) // 4]:.3f}, {len(v)} runs)"


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_route_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    srv = Server("bert_base", batch=8, max_seq=256, mode="npe-8bit", device=dev, seed=0)
    prompts = decode_prompts(srv.cfg.vocab_size)
    start = max(len(p) for p in prompts)
    cur = torch.tensor([[int(p[-1])] for p in prompts], device=dev)
    srv.generate(prompts, gen_tokens=2)                 # warm-up
    prefill = {"dense": [], "blocked": []}
    step = {"dense": [], "blocked": []}

    def serve(route):
        for slot, p in enumerate(prompts):
            prefill[route].append(timed(lambda: srv.prefill_prompt(slot, p)))
        for i in range(STEPS):
            step[route].append(timed(lambda: registry.decode_step(
                srv.cfg, srv.model, srv.cache, cur, start + i)))

    for rnd in range(ROUNDS):
        for route in ("dense", "blocked") if rnd % 2 == 0 else ("blocked", "dense"):
            if route == "blocked":
                with BlockedAttention():
                    serve(route)
            else:
                serve(route)
    print(f"card: {card_info()}; NPE-8, 8 slots, prompts of {[len(p) for p in prompts]} tokens")
    for route in ("dense", "blocked"):
        print(f"  {route:8s} prefill ms/slot {spread(prefill[route])}; "
              f"decode ms/step {spread(step[route])}")
    from torch.profiler import ProfilerActivity, profile
    for route in ("dense", "blocked"):
        with BlockedAttention() if route == "blocked" else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                srv.prefill_prompt(3, prompts[3])
                torch.cuda.synchronize()
        t = _kernel_times(prof, with_counts=True)
        flash = sum(us for k, us, _ in t if "flash" in k) / 1e3
        print(f"  {route:8s} one prefill of {len(prompts[3])} tokens: device busy "
              f"{sum(us for _, us, _ in t) / 1e3:.3f} ms, {sum(n for _, _, n in t)} launches, "
              f"flash kernels {flash:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched KV-cache decode serving (counterpart of the jnp backend of
`repro/launch/serve.py`: `ServeStats`, `Server` and its CLI).

A fixed pool of B decode slots for any model of the port with a decode
step (`--arch`: BERT's causal step, a dense, vlm or MoE transformer such as
glm4_9b, gemma3_27b or granite_moe_1b_a400m, RWKV6, the Hymba hybrid or
Whisper's decoder).  Each prompt is prefilled alone on its slot's slice of
the cache: by one multi-token `decode_step` at position 0 where the cache
is a `full` KV group alone, else (window rings, recurrent states, a cross
cache) one token a step at positions 0..S-1, as the reference does; then
every slot decodes one greedy token a step on one common position clock
that starts at the longest prompt's length.  As in the reference, a
slot with a shorter prompt attends over the zero cache rows between its
length and that start, and each slot's last prompt token is fed again at
the start; Whisper's cross cache starts at zero, as the reference server's
does, until a caller fills it (`encdec.init_cross_cache`).  Every attention
goes through the flash-attention kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --max-seq 256 \
        --gen 64 --mode npe-8bit
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --mode npe-8bit
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_27b --max-prompt 16 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_1b_a400m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b --max-prompt 16 --gen 16

prints the prefill ms per slot, the ms per decode step and tokens/s on the
card, with the card's name and power limit.

`--backend npec` serves from compiled overlay streams instead (counterpart
of the reference's `run_npec` / `run_npec_fleet`): `NPEEngine` runs the npec
executor on the card (`--device`), and `--overlays N` / `--shard` / `--rate`
run the cost-only `NPEFleet`.  The latencies and tokens/s they print are the
FPGA overlay model's at 200 MHz, never time on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --backend npec --npe \
        --bits 8 --batch 8 --capacity 64 --gen 16 --requests 12
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


# the fields of a given model's config that the server takes: its depth and
# the dtype of its weights and activations
MODEL_FIELDS = ("num_layers", "encoder_layers", "decoder_layers", "dtype")


def slot_view(cache, slot: int):
    """The cache tree's views of one slot: every tensor's batch axis (the
    second) narrowed to [slot, slot + 1)."""
    if isinstance(cache, dict):
        return {k: slot_view(v, slot) for k, v in cache.items()}
    return cache[:, slot:slot + 1]


class Server:
    """Decode-slot server for a model with a decode step (`arch`: BERT's
    causal decode step, a dense, vlm or MoE transformer, RWKV6, the hybrid
    or Whisper's decoder) in one mode (float, NPE-8 or NPE-16).

    `model` shares weights between servers; without it the server draws
    random weights from `seed` on its device (`registry.build_model`).  Full
    width and depth unless `smoke`; a given model sets the served depth and
    dtype (a model cut in depth serves at its own number of layers, a
    float32 model in float32: `MODEL_FIELDS`)."""

    def __init__(self, arch: str = "bert_base", batch: int = 4, max_seq: int = 128,
                 mode: str = "float", device="cuda", model: Optional[torch.nn.Module] = None,
                 seed: int = 0, smoke: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server: no CUDA device; pass device='cpu' to serve "
                               "on the CPU")
        if mode not in MODES:
            raise KeyError(f"unknown mode {mode!r}; have {sorted(MODES)}")
        cfg = get_config(arch, smoke=smoke)
        if model is not None:
            cfg = dataclasses.replace(cfg, **{k: getattr(model.cfg, k) for k in MODEL_FIELDS})
        if max_seq > cfg.max_position:
            raise ValueError(f"max_seq {max_seq} > max_position {cfg.max_position}")
        self.cfg = MODES[mode](cfg)
        self.batch, self.max_seq, self.device = batch, max_seq, device
        if model is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            model = registry.build_model(cfg, device=device, generator=gen)
        self.model = model
        self.decode = build_decode_step(self.cfg)
        self.cache = registry.init_cache(self.cfg, batch, max_seq, device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill one slot on its slice of the cache (views of every tensor,
        whose batch axis is the second, written in place): where the cache
        is exactly a `full` KV group, the whole prompt through one
        `decode_step` at positions 0..S-1; else (window rings, recurrent
        states, a cross cache) one token a call at position t, as the
        reference's `prefill_prompt` does."""
        sub = slot_view(self.cache, slot)
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=self.device)[None]
        if set(sub) == {"full"}:
            registry.decode_step(self.cfg, self.model, sub, toks, 0)
            return
        for t in range(toks.shape[1]):
            registry.decode_step(self.cfg, self.model, sub, toks[:, t:t + 1], t)

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


# cycle reports carry full precision; these keys are rounded here, at the
# presentation layer, so the printed lines match the reference's records
_PRINT_ROUND = {"tokens_per_sec": 1, "mmu_row_occupancy": 4}
OVERLAY_LABEL = "overlay model (FPGA, 200 MHz), not time on the card"


def _print_report(report: Dict) -> None:
    for k, v in report.items():
        if k in _PRINT_ROUND and isinstance(v, float):
            v = round(v, _PRINT_ROUND[k])
        unit = "  [overlay model]" if k.endswith("_ms") or k == "tokens_per_sec" else ""
        print(f"  {k}: {v}{unit}")


def _make_tracer(args, clock_hz: float):
    """A live cycle tracer when --trace is set, else None (the engine and
    fleet then default to the no-op NULL_TRACER)."""
    if not args.trace:
        return None
    from repro_torch.npec.obs import Tracer
    return Tracer(clock_hz=clock_hz)


def _npec_outputs(args, tracer, snapshot: Dict) -> None:
    """--json / --trace artifacts from one run's stats snapshot."""
    if args.json:
        with open(args.json, "w") as f:
            json.dump(snapshot, f, indent=1)
            f.write("\n")
        print(f"wrote json report -> {args.json}")
    if tracer is not None:
        from repro_torch.npec.obs import write_chrome_trace
        write_chrome_trace(tracer, args.trace, report=snapshot["report"],
                           metrics=snapshot["metrics"])
        print(f"wrote trace -> {args.trace} ({len(tracer.events)} events)")


def _max_prompt(args) -> int:
    max_prompt = args.capacity - args.gen
    if max_prompt < 4:
        raise SystemExit(
            f"--capacity ({args.capacity}) must be at least --gen ({args.gen}) + 4: "
            f"prompts are 4..{max_prompt} tokens and every request must fit "
            "prompt + generation in its cache slot")
    return max_prompt


def run_npec_fleet(args) -> Dict[str, float]:
    """Multi-overlay serving: N overlays pull from one admission queue, as
    replicas or with one model's streams sharded (pipeline, tensor,
    prefill_decode), inter-overlay transfers itemized.  Cost-only, as in the
    reference: no tensor, no device; arrivals from the seeded Poisson
    process when --rate is set."""
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.npec.fleet import NPEFleet

    cfg = get_config(args.arch, smoke=args.smoke)
    hw = NPEHardware(vrwidth=args.vrwidth)
    tracer = _make_tracer(args, hw.clock_hz)
    max_prompt = _max_prompt(args)
    fleet = NPEFleet(cfg, hw, overlays=args.overlays, shard=args.shard,
                     slots=args.batch, capacity=args.capacity,
                     max_new_tokens=args.gen, bits=args.bits,
                     cycle_model=args.cycle_model,
                     prefill_chunk=args.prefill_chunk,
                     prefill_overlays=args.prefill_overlays,
                     seq_buckets=args.seq_buckets, window=args.window,
                     tracer=tracer)
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=min(16, max_prompt),
                             rate_rps=args.rate, clock_hz=hw.clock_hz)
    arrivals = reqs.arrival_cycles(args.requests)
    for i in range(args.requests):
        fleet.submit(reqs.request(i), eos_id=reqs.eos_id(i),
                     arrival_cycle=int(arrivals[i]))
    snapshot = fleet.run().snapshot()
    report = snapshot["report"]
    print(f"npec fleet ({args.arch}, {args.overlays} overlays, shard={args.shard}, "
          f"{args.bits}-bit MMU, rate={args.rate or 'all-at-t0'}, "
          f"{args.cycle_model} cycle model), cost-only; {OVERLAY_LABEL}:")
    _print_report(report)
    _npec_outputs(args, tracer, snapshot)
    return report


def run_npec(args) -> Dict[str, float]:
    """Compiled-stream serving: `NPEEngine` over the synthetic workload, the
    executor's kernels on `--device`.  The weights are the port's own
    `models/bert` initialisation at --seed (through `param_tree_from_model`),
    not the reference's `registry.init_params`.  Latency and tokens/s come
    from the compiled streams' cycle counts (the overlay model at 200 MHz);
    the host seconds of the run on the device are printed beside them."""
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.models.convert import param_tree_from_model
    from repro_torch.npec.runtime import NPEEngine

    cfg = get_config(args.arch, smoke=args.smoke)
    max_prompt = _max_prompt(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve --backend npec: no CUDA device; pass --device cpu")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = param_tree_from_model(Bert(cfg, device=device).init(gen))
    hw = NPEHardware(vrwidth=args.vrwidth)
    tracer = _make_tracer(args, hw.clock_hz)
    engine = NPEEngine(cfg, hw, slots=args.batch, capacity=args.capacity,
                       max_new_tokens=args.gen, bits=args.bits, npe=args.npe,
                       params=params, cycle_model=args.cycle_model,
                       prefill_chunk=args.prefill_chunk,
                       seq_buckets=args.seq_buckets, window=args.window,
                       tracer=tracer, device=device)
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=min(16, max_prompt))
    for i in range(args.requests):
        # EOS-aware workload: each request carries a sampled stop token
        engine.submit(reqs.request(i), eos_id=reqs.eos_id(i))
    t0 = time.perf_counter()
    snapshot = engine.run().snapshot()
    host_s = time.perf_counter() - t0
    report = snapshot["report"]
    print(f"npec engine ({args.arch}, B={args.batch} slots, T={args.capacity}, "
          f"{args.bits}-bit MMU, {'NPE' if args.npe else 'float'} numerics on "
          f"{device}, {args.cycle_model} cycle model); {OVERLAY_LABEL}:")
    _print_report(report)
    where = card_info() if device.type == "cuda" else "the CPU"
    print(f"host time of the run: {host_s:.3f} s for {report['decode_steps']} "
          f"engine steps on {where}")
    _npec_outputs(args, tracer, snapshot)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="bert_base",
                    help="a config of the port (all have a decode step): bert_base, "
                         "glm4_9b, command_r_plus_104b, qwen2_vl_7b, starcoder2_3b, "
                         "gemma3_27b, granite_moe_1b_a400m, llama4_maverick_400b_a17b, "
                         "rwkv6_3b, hymba_1_5b, whisper_base (--backend npec: bert_base "
                         "only)")
    ap.add_argument("--backend", choices=("torch", "npec"), default="torch",
                    help="torch: Server.generate, the model's own decode step; "
                         "npec: compiled overlay streams (NPEEngine / NPEFleet)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-prompt", type=int, default=128)
    ap.add_argument("--gen", type=int, default=None,
                    help="tokens generated a request (default 64; --backend npec 16)")
    ap.add_argument("--mode", default="npe-8bit", choices=sorted(MODES))
    ap.add_argument("--seed", type=int, default=0,
                    help="weights: the port's own initialisation of the model at "
                         "this seed (the card has no JAX, so never the "
                         "reference's registry.init_params)")
    npec = ap.add_argument_group("--backend npec")
    npec.add_argument("--device", default="cuda",
                      help="where NPEEngine's executor runs (default: the card)")
    npec.add_argument("--requests", type=int, default=8)
    npec.add_argument("--capacity", type=int, default=48,
                      help="compiled KV-cache capacity per slot")
    npec.add_argument("--cycle-model", choices=("dag", "streaming"),
                      default="streaming",
                      help="cycles each serving step charges: tile-streaming "
                           "(the paper's model) or whole-op DAG")
    npec.add_argument("--npe", action="store_true",
                      help="NPE numerics (quantized MMU at --bits, PWL NVU)")
    npec.add_argument("--bits", type=int, default=16)
    npec.add_argument("--vrwidth", type=int, default=1024)
    npec.add_argument("--overlays", type=int, default=1,
                      help="overlays in the cost-only fleet (1: the lone engine)")
    npec.add_argument("--shard", choices=("replicate", "expert", "pipeline",
                                          "prefill_decode", "tensor"),
                      default="replicate",
                      help="fleet: replicas, pipeline layer groups, prefill/decode "
                           "disaggregation or column-carved tensor parallelism "
                           "(expert needs the npec streams of an MoE family, which "
                           "the port lacks)")
    npec.add_argument("--rate", type=float, default=None,
                      help="fleet: Poisson request rate (requests/s at the overlay "
                           "clock); default all at cycle 0")
    npec.add_argument("--prefill-chunk", type=int, default=None,
                      help="stream each prompt as ceil(S/C) causal cache slices")
    npec.add_argument("--prefill-overlays", type=int, default=1,
                      help="fleet: prefill overlays under --shard prefill_decode")
    npec.add_argument("--seq-buckets", default=None,
                      help="length-bucketed decode: 'auto' or a comma list")
    npec.add_argument("--window", type=int, default=None,
                      help="ring (sliding-window) decode at W rows")
    npec.add_argument("--trace", default=None, metavar="PATH",
                      help="write a Chrome trace-event/Perfetto JSON of the run "
                           "(cycle-stamped); read it with python -m "
                           "repro_torch.npec.obs.profile PATH")
    npec.add_argument("--json", "--report", dest="json", default=None, metavar="PATH",
                      help="write the cycle report + metrics snapshot as JSON")
    npec.add_argument("--smoke", action="store_true",
                      help="the smoke configuration and a tiny workload: 2 slots, "
                           "4 requests, 4 tokens")
    args = ap.parse_args(argv)
    if args.gen is None:
        args.gen = 16 if args.backend == "npec" else 64
    if args.backend == "npec":
        if args.seq_buckets and args.seq_buckets != "auto":
            args.seq_buckets = tuple(int(b) for b in args.seq_buckets.split(","))
        if args.smoke:
            args.batch, args.requests, args.gen = 2, 4, 4
            args.capacity = min(args.capacity, 24)
        if (args.overlays, args.shard, args.rate) == (1, "replicate", None):
            run_npec(args)
        else:
            run_npec_fleet(args)
        print("serve OK")
        return
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

"""Training on the card: a step's time and launches, and how the loss moves
under a set of AdamW settings.

    PYTHONPATH=src python3 scripts/train_probe.py timing [--steps 6]
    PYTHONPATH=src python3 scripts/train_probe.py loss --steps 150 \\
        --opt '{"lr": 3e-4, "warmup_steps": 10}' [--opt '{...}' ...] \\
        [--dtype float32] [--remat none] [--arch starcoder2_3b --batch 4 --seq 1024]
    PYTHONPATH=src python3 scripts/train_probe.py profile --arch starcoder2_3b \\
        --batch 4 --seq 1024 [--steps 3] [--modes float,npe-8bit] [--json out.json]

Both run `launch.train.Trainer` on a full-width model at full depth
(float32 masters, bf16 compute, remat "block"): BERT-base on
`SyntheticLM(30720, 128, 8)` unless `--arch`, `--batch` and `--seq` say
otherwise; no checkpoint is written (`Trainer.train(checkpoints=False)`).
`timing` trains float, NPE-16 and NPE-8 for `--steps` steps each (the
reference's AdamW defaults but lr 1e-3, warmup 2) and prints each step's
loss and host seconds (ending in a synchronize), the kernel launches a
step, the peak memory, and one checkpoint save and restore in seconds.
`loss` trains float once for each `--opt` (OptimizerConfig fields as JSON,
schedule "constant" unless given), with the compute dtype and remat of
`--dtype` and `--remat` (bfloat16 and "block" unless given), and prints the
mean loss of each 10 steps and of the first and last 5.  `profile` trains
each of `--modes` for `--steps` steps (host ms a step, the median past the
first), then takes one more step under torch.profiler and prints the device
busy ms, the idle share, the ten device kernels that take the most time,
and the share of the dense attention's forward kernels and of its backward
kernels (names holding `flash_dense` and `dense_grad`).  Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.config import OptimizerConfig  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.launch.train import Trainer, make_run  # noqa: E402


ARCH = dict(arch="bert_base", batch=8, seq=128)


def run_config(steps, npe=False, bits=8, dtype="bfloat16", remat="block", **opt):
    run = make_run(ARCH["arch"], False, steps, ARCH["batch"], ARCH["seq"], npe=npe, bits=bits,
                   ckpt_dir=tempfile.mkdtemp(prefix="train_probe_"),
                   opt=OptimizerConfig(decay_steps=steps, **opt))
    return dataclasses.replace(run, model=dataclasses.replace(run.model, dtype=dtype),
                               remat=remat, log_every=10 ** 9,
                               checkpoint=dataclasses.replace(run.checkpoint, interval=0))


def timing(steps):
    for npe, bits in ((False, 8), (True, 16), (True, 8)):
        tr = Trainer(run_config(steps, npe, bits, lr=1e-3, warmup_steps=2), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for s in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.model, tr.opt_state, m = tr.step_fn(tr.model, tr.opt_state, tr.batch_at(s))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            print(f"npe={npe} bits={bits} step {s} loss {loss:.4f} {time.perf_counter() - t0:.3f} s",
                  flush=True)
        per_step = {k: v // steps for k, v in launches().items()}
        print(f"  launches a step {per_step}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        if ARCH["arch"] == "bert_base":
            t0 = time.perf_counter()
            tr._save(0)
            tr.ckpt.wait()
            t1 = time.perf_counter()
            tr._restore()
            print(f"  save {t1 - t0:.2f} s, restore {time.perf_counter() - t1:.2f} s",
                  flush=True)
        del tr
        torch.cuda.empty_cache()


def loss(steps, opts, dtype, remat):
    for opt in opts:
        kw = dict(schedule="constant", **json.loads(opt))
        t0 = time.perf_counter()
        out = Trainer(run_config(steps, dtype=dtype, remat=remat, **kw), log=lambda *a: None,
                      device="cuda").train(checkpoints=False)
        torch.cuda.empty_cache()
        ls = np.array([h["loss"] for h in out["history"]])
        print(ARCH["arch"], dtype, remat, f"{time.perf_counter() - t0:.1f} s", kw,
              [round(float(x), 3) for x in ls], "first 5", float(ls[:5].mean()),
              "last 5", float(ls[-5:].mean()), flush=True)


ATTENTION_KERNELS = {"dense forward": "flash_dense", "dense backward": "dense_grad"}


def profile(steps, modes, out_path):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    out = {}
    for mode in modes:
        npe, bits = mode != "float", 16 if mode == "npe-16bit" else 8
        tr = Trainer(run_config(steps + 1, npe, bits, lr=1e-3, warmup_steps=2), device="cuda")
        host = []
        for s in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.model, tr.opt_state, m = tr.step_fn(tr.model, tr.opt_state, tr.batch_at(s))
            float(m["loss"])
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        host_ms = float(np.median(host[1:] if len(host) > 1 else host))
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.model, tr.opt_state, m = tr.step_fn(tr.model, tr.opt_state, tr.batch_at(steps))
            torch.cuda.synchronize()
        kernels = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            if us > 0:
                kernels.append((e.key, us / 1e3, e.count))
        kernels.sort(key=lambda t: -t[1])
        busy = sum(ms for _, ms, _ in kernels)
        shares = {label: (sum(ms for k, ms, _ in kernels if key in k),
                          sum(n for k, _, n in kernels if key in k))
                  for label, key in ATTENTION_KERNELS.items()}
        print(f"{ARCH['arch']} {mode}: host {host_ms:.1f} ms a step (median of {host}), device "
              f"busy {busy:.1f} ms, idle share {1 - busy / host_ms:.3f}, "
              f"{sum(n for _, _, n in kernels)} device launches", flush=True)
        for label, (ms, n) in shares.items():
            print(f"  {label}: {ms:.2f} ms in {n} launches, {ms / busy:.1%} of device busy",
                  flush=True)
        for name, ms, n in kernels[:10]:
            print(f"  {ms:9.2f} ms {n:6d} x  {ms / busy:6.1%}  {name[:110]}", flush=True)
        out[mode] = dict(host_ms=host_ms, host_runs=host, device_busy_ms=busy,
                         idle_share=1 - busy / host_ms, top=kernels[:10],
                         attention={k: dict(ms=ms, launches=n) for k, (ms, n) in shares.items()})
        del tr
        torch.cuda.empty_cache()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(dict(card=card.strip(), arch=ARCH, **out), indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("timing", "loss", "profile"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--opt", action="append", default=[])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--remat", default="block", choices=("block", "none"))
    ap.add_argument("--arch", default="bert_base")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--modes", default="float,npe-8bit")
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    ARCH.update(arch=args.arch, batch=args.batch, seq=args.seq)
    if not torch.cuda.is_available():
        sys.exit("train_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.what == "timing":
        timing(args.steps)
    elif args.what == "profile":
        profile(args.steps, args.modes.split(","), args.json)
    else:
        loss(args.steps, args.opt, args.dtype, args.remat)


if __name__ == "__main__":
    main()

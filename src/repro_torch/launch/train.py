"""Fault-tolerant training loop (counterpart of `repro/launch/train.py`).

Wires together: config -> data pipeline -> train step -> checkpoint and
restore -> fault supervisor.  The model's float32 masters, its AdamW
moments and the batches live on the run's device, on one card: the mesh
is (1, 1).  BERT and the dense, vlm and moe decoders train
(`registry.require_trainable`); RWKV6 (ssm) and Hymba (hybrid) raise
NotImplementedError until their recurrences have a backward pass, and
Whisper (encdec) until its trainer path (audio frames beside the tokens)
is ported.  A vlm batch holds seq - num_patches tokens and, as the
reference's `batch_specs` lays it out, num_patches stub patch embeddings
(seeded normal values: the modality frontend is a stub).

Usage (on the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch bert_base \\
        [--npe [--bits 8|16]] --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --steps 10 --batch 4 --seq 1024 --no-checkpoints
`--smoke` takes the reduced config, `--device cpu` runs on the CPU;
`--no-checkpoints` writes none (a 3B model's state is 51 GB).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.config import (CheckpointConfig, FaultConfig, MeshConfig,
                                OptimizerConfig, RunConfig, ShapeConfig)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import build_train_step, trainable
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime.fault import Supervisor, run_with_recovery


def make_run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
             npe: bool = False, bits: int = 8, mesh_shape=None,
             ckpt_dir: Optional[str] = None,
             fault: Optional[FaultConfig] = None,
             opt: Optional[OptimizerConfig] = None) -> RunConfig:
    cfg = get_config(arch, smoke=smoke)
    if npe:
        cfg = cfg.with_npe(bits)
    mesh_cfg = MeshConfig(("data", "model"), tuple(mesh_shape or (1, 1)), profile="tp")
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("custom", "train", seq, batch),
        mesh=mesh_cfg,
        optimizer=opt or OptimizerConfig(warmup_steps=10, decay_steps=steps),
        # without a directory, a fresh one a run: a stale step_* of an earlier
        # run would sort after this run's and be kept in its place
        checkpoint=CheckpointConfig(
            directory=ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_"), interval=50),
        fault=fault or FaultConfig(),
        steps=steps,
    )


class Trainer:
    """The training loop of `run` on `device` ("cuda" unless the caller asks
    for the CPU): the model's float32 masters from the seed, AdamW, a
    checkpoint at step 0, every `checkpoint.interval` steps and at the end,
    and a rewind to the latest checkpoint on a failure the supervisor
    raises (a non-finite loss, an injected crash)."""

    def __init__(self, run: RunConfig, log=print, device="cuda"):
        if run.mesh.num_devices != 1:
            raise NotImplementedError(
                f"mesh {run.mesh.describe()}: the port trains on one device, the (1, 1) "
                "mesh; sharding comes with the distribution layer")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): no CUDA device; pass device='cpu'")
        registry.require_trainable(run.model)
        self.run = run
        self.log = log
        self.device = torch.device(device)
        cfg = run.model
        self.patches = cfg.num_patches if cfg.family == "vlm" else 0
        if self.patches >= run.shape.seq_len:
            raise ValueError(f"{cfg.name}: seq {run.shape.seq_len} leaves no tokens beside "
                             f"{self.patches} patches")
        self.data = SyntheticLM(cfg.vocab_size, run.shape.seq_len - self.patches,
                                run.shape.global_batch, seed=run.seed)
        self.ckpt = Checkpointer(run.checkpoint.directory, keep=run.checkpoint.keep,
                                 async_save=run.checkpoint.async_save)
        self.supervisor = Supervisor(run.fault)
        self.history: list[Dict[str, float]] = []
        self.step_fn = build_train_step(run)
        self.checkpoints = True
        self._init_state()

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        self.model = registry.init_params(self.run.model, gen, device=self.device,
                                          dtype=getattr(torch, self.run.param_dtype))
        self.model.requires_grad_(True)
        self.opt_state = adamw.init(self.run.optimizer, trainable(self.model))

    def state(self) -> Dict[str, Any]:
        return {"params": trainable(self.model), "opt": self.opt_state}

    # --- checkpoint plumbing ------------------------------------------

    def _save(self, step: int):
        self.ckpt.save(step, self.state(), extra={"arch": self.run.model.name})

    def _restore(self) -> int:
        self.ckpt.wait()                 # a save still in flight commits first
        state, step = self.ckpt.restore(self.state())
        with torch.no_grad():
            for name, p in trainable(self.model).items():
                p.copy_(state["params"][name])
        self.opt_state = state["opt"]
        self.log(f"[recover] restored checkpoint at step {step} "
                 f"(restart #{self.supervisor.restarts})")
        return step + 1

    # --- the loop ------------------------------------------------------

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Step `step`'s batch on the device (the same for the same step, so
        a rewound step sees its batch again); a vlm's with its patches."""
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in self.data.batch_at(step).items()}
        if self.patches:
            cfg = self.run.model
            gen = torch.Generator().manual_seed(self.run.seed * 1_000_003 + step)
            shape = (self.run.shape.global_batch, self.patches, cfg.d_model)
            out["embeds"] = torch.randn(shape, generator=gen).to(self.device,
                                                                  getattr(torch, cfg.dtype))
        return out

    def _loop(self, start_step: int) -> Dict[str, Any]:
        run = self.run
        for step in range(start_step, run.steps):
            t0 = time.perf_counter()
            self.supervisor.check_crash(step)
            batch = self.batch_at(step)
            self.model, self.opt_state, metrics = self.step_fn(self.model, self.opt_state,
                                                               batch)
            loss = float(metrics["loss"])
            elapsed = time.perf_counter() - t0
            self.supervisor.check_deadline(step, elapsed)
            self.supervisor.check_loss(step, loss)
            self.history.append({"step": step, "loss": loss, "sec": elapsed})
            if step % run.log_every == 0:
                self.log(f"step {step:5d} loss {loss:.4f} "
                         f"lr {float(metrics['lr']):.2e} "
                         f"gnorm {float(metrics['grad_norm']):.2f} "
                         f"({elapsed:.2f}s)")
            if (self.checkpoints and run.checkpoint.interval > 0
                    and (step + 1) % run.checkpoint.interval == 0):
                self._save(step)
        if self.checkpoints:
            self._save(run.steps - 1)
            self.ckpt.wait()
        return {"final_loss": self.history[-1]["loss"],
                "history": self.history,
                "fault_events": self.supervisor.events,
                "restarts": self.supervisor.restarts}

    def train(self, checkpoints: bool = True) -> Dict[str, Any]:
        """Run the steps.  With checkpoints=False nothing is saved (a state
        too large to write each run: StarCoder2-3B's masters and moments are
        51 GB) and a failure is not recovered: it raises."""
        self.checkpoints = checkpoints
        if not checkpoints:
            return self._loop(0)
        # save a step-0 checkpoint so the first rewind has a target
        self._save(0)
        return run_with_recovery(self._loop, self._restore, self.supervisor)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert_base")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--npe", action="store_true")
    ap.add_argument("--bits", type=int, default=8, choices=(8, 16))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-checkpoints", action="store_true",
                    help="write no checkpoint (a failure is then not recovered)")
    args = ap.parse_args(argv)
    run = make_run(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   npe=args.npe, bits=args.bits, ckpt_dir=args.ckpt_dir)
    out = Trainer(run, device=args.device).train(checkpoints=not args.no_checkpoints)
    print(f"done: final loss {out['final_loss']:.4f}, restarts {out['restarts']}")


if __name__ == "__main__":
    main()

"""BERT's training loss under the reference's train step and the port's,
side by side on the CPU.

    PYTHONPATH=src python3 scripts/train_curve_vs_reference.py --steps 300 \\
        [--full-width --layers 2] [--vocab V] [--dtype float32] \\
        [--opt '{"lr": 1e-3, "warmup_steps": 10}'] [--every 10]

Both start from the reference's float32 `init_params` (seed 0) and take the
same `SyntheticLM` batches (8 x 128): `repro.launch.steps.build_train_step`
(jitted) and `repro_torch.launch.steps.build_train_step`, AdamW with the
reference's `OptimizerConfig` defaults but `decay_steps` = --steps and the
fields given in --opt.  The model is the smoke `bert_base` (2 layers, D 128,
vocab 512), or with --full-width BERT-base's widths (D 768, vocab 30720) at
--layers layers; --vocab replaces the vocabulary.  Prints both losses and
gradient norms every --every steps and the mean loss of the first and last
5 steps.  A full-width step of both takes several seconds.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import repro.config as rconfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.steps import build_train_step as ref_build_train_step  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch import config as pconfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import build_train_step, trainable  # noqa: E402
from repro_torch.models.convert import masters_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

BATCH, SEQ = 8, 128


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--opt", default='{"lr": 1e-3, "warmup_steps": 10}')
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args()
    over = dict(dtype=args.dtype, num_layers=args.layers)
    if args.vocab:
        over["vocab_size"] = args.vocab
    smoke = not args.full_width
    rc = dataclasses.replace(ref_get_config("bert_base", smoke=smoke), **over)
    pc = dataclasses.replace(get_config("bert_base", smoke=smoke), **over)
    opt = dict(decay_steps=args.steps, **json.loads(args.opt))
    shape = ("custom", "train", SEQ, BATCH)
    rrun = rconfig.RunConfig(model=rc, shape=rconfig.ShapeConfig(*shape),
                             mesh=rconfig.SMOKE_MESH, optimizer=rconfig.OptimizerConfig(**opt))
    prun = pconfig.RunConfig(model=pc, shape=pconfig.ShapeConfig(*shape),
                             mesh=pconfig.SMOKE_MESH, optimizer=pconfig.OptimizerConfig(**opt))
    tree = jax.tree.map(np.asarray, ref_registry.init_params(rc, jax.random.PRNGKey(0)))
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = ref_adamw.init(rrun.optimizer, rparams)
    rstep = jax.jit(ref_build_train_step(rrun))
    model = masters_from_jax(tree, pc).requires_grad_(True)
    popt = adamw.init(prun.optimizer, trainable(model))
    pstep = build_train_step(prun)
    data = SyntheticLM(rc.vocab_size, SEQ, BATCH)
    print(f"bert_base L={rc.num_layers} D={rc.d_model} V={rc.vocab_size} {rc.dtype}, "
          f"{BATCH} x {SEQ}, AdamW {rrun.optimizer}", flush=True)
    ref_loss, port_loss = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        b = data.batch_at(step)
        rparams, ropt, rm = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in b.items()})
        model, popt, pm = pstep(model, popt, {k: torch.as_tensor(v) for k, v in b.items()})
        ref_loss.append(float(rm["loss"]))
        port_loss.append(float(pm["loss"]))
        if step % args.every == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss reference {ref_loss[-1]:.4f} port {port_loss[-1]:.4f}; "
                  f"gradient norm {float(rm['grad_norm']):.3f} / {float(pm['grad_norm']):.3f}",
                  flush=True)
    ends = lambda ls: f"{np.mean(ls[:5]):.4f} -> {np.mean(ls[-5:]):.4f}"
    print(f"mean loss of the first and last 5 steps: reference {ends(ref_loss)}, port "
          f"{ends(port_loss)}; {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

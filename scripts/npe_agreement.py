"""NPE top-1 agreement and logits' correlation with float at a model's full
widths, the reference and the port side by side, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/npe_agreement.py \
        [--arch glm4_9b] [--layers 2] [--vocab 16384] [--batch 2] [--seq 64] \
        [--bits 8] [--dtypes bfloat16 float32]

Both packages take the same random weights (the reference's
`registry.init_params`, moved to the port through `params_from_jax`) of
`--arch` at its full width (glm4_9b: d_model 4096, d_ff 13696, 32 query
heads over 2 kv heads of 128; rwkv6_3b, hymba_1_5b likewise) cut to
`--layers` layers and `--vocab` vocabulary rows (GLM4's whole 151552-row
head and embedding would hold some 5 GB more a copy; the layers' widths are
the model's).  Each package computes the logits of a `--batch` x `--seq`
token batch in float and in NPE at each of `--bits`, op by op (the
reference under `jax.disable_jit()`), in each dtype, and the script prints
each one's top-1 agreement of NPE with its own float over every position,
the correlation of its NPE logits with its float logits (the reference's
measure in tests/test_npe_accuracy.py), and the two packages' NPE logits'
largest difference.

It answers whether the port's NPE agrees less with float than the
reference's does on the same weights (a fault of the port) or as much (a
property of the random weights and the dtype).
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import registry as ref_registry
from repro_torch.configs import get_config as port_config
from repro_torch.models import registry
from repro_torch.models.convert import params_from_jax


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--bits", type=int, nargs="+", default=[8])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    torch.set_float32_matmul_precision("highest")
    over = dict(num_layers=args.layers, vocab_size=args.vocab)
    ref = dataclasses.replace(ref_config(args.arch), **over)
    port = dataclasses.replace(port_config(args.arch), **over)
    t0 = time.perf_counter()
    params = jax.tree_util.tree_map(np.asarray,
                                    ref_registry.init_params(ref, jax.random.PRNGKey(0)))
    state = params_from_jax(params, port)
    tokens = np.random.default_rng(1).integers(0, args.vocab, (args.batch, args.seq)
                                               ).astype(np.int32)
    print(f"{args.arch} widths, {args.layers} layers, vocab {args.vocab}, {args.batch} x "
          f"{args.seq} tokens; weights in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for dtype in args.dtypes:
        rc = dataclasses.replace(ref, dtype=dtype)
        pc = dataclasses.replace(port, dtype=dtype)
        model = registry.build_model(pc, device="cpu")
        model.load_state_dict(state)
        logits = {}
        modes = ["float"] + [f"npe{b}" for b in args.bits]
        for mode in modes:
            bits = int(mode[3:]) if mode != "float" else None
            r = rc.with_npe(quant_bits=bits) if bits else rc
            p = pc.with_npe(quant_bits=bits) if bits else pc
            with jax.disable_jit():
                logits[("reference", mode)] = np.asarray(
                    ref_registry.apply(r, params, jnp.asarray(tokens), remat=False), np.float32)
            logits[("port", mode)] = registry.apply(
                p, model, torch.from_numpy(tokens).long()).float().numpy()
        del model
        for mode in modes[1:]:
            row = {}
            for pkg in ("reference", "port"):
                npe, fl = logits[(pkg, mode)], logits[(pkg, "float")]
                row[pkg] = float((npe.argmax(-1) == fl.argmax(-1)).mean())
                row[f"{pkg}_corr"] = float(np.corrcoef(npe.ravel(), fl.ravel())[0, 1])
            row["npe_port_vs_reference_max_abs"] = float(np.abs(
                logits[("port", mode)] - logits[("reference", mode)]).max())
            row["float_port_vs_reference_max_abs"] = float(np.abs(
                logits[("port", "float")] - logits[("reference", "float")]).max())
            row["port_npe_top1_vs_reference_npe"] = float(
                (logits[("port", mode)].argmax(-1) == logits[("reference", mode)].argmax(-1)
                 ).mean())
            out[f"{dtype} {mode}"] = row
            print(f"{dtype:9s} {mode}: top-1 agreement with its own float: reference "
                  f"{row['reference']:.4f}, port {row['port']:.4f}; correlation: reference "
                  f"{row['reference_corr']:.5f}, port {row['port_corr']:.5f}; NPE logits port "
                  f"vs reference max-abs {row['npe_port_vs_reference_max_abs']:.3e} (float "
                  f"{row['float_port_vs_reference_max_abs']:.3e}), NPE top-1 port vs reference "
                  f"{row['port_npe_top1_vs_reference_npe']:.4f}", flush=True)
    print(json.dumps(dict(vars(args), results=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Mutation check of `chip_smoke.py`'s training route gates, on the CPU.

    PYTHONPATH=src python3 scripts/train_route_mutants.py --work DIR

The route check ([15] (d)) holds one train step of the card's kernel route
to the port's plain route, BERT-base at full width cut to 2 layers in
float32, with gates widened past the plain route's 1-ulp change by an NPE
floor and an AdamW allowance (`chip_smoke.train_route_compare`).  This
script shows what those gates still catch: it copies `chip_smoke.py` and
`src/repro_torch` into DIR (outside the repository) once for each planted
fault in a plain backward pass, runs the plain route's step and its 1-ulp
changes once from the unchanged tree (`train_route_cpu`), then each faulty
tree's step in NPE-16 and NPE-8, and prints each tree's worst error as a
share of its gate (above 1 fails).  A fault on a path that this data never
takes (a tie of a clip end, of `maximum`, or of the amax) changes nothing
and is reported so: the tied inputs of tests/test_torch_train_grads.py and
tests/test_torch_train_cuda.py reach it.  About 2 minutes on 4 CPU threads.
"""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PWL = "src/repro_torch/kernels/pwl_eval.py"
SOFTMAX = "src/repro_torch/kernels/nvu_softmax.py"
NORM = "src/repro_torch/kernels/nvu_layernorm.py"
QUANT = "src/repro_torch/core/quant.py"
MMU = "src/repro_torch/kernels/quant_matmul.py"
# name -> [(file, text, the text that replaces it)]
FAULTS = {
    "slope one segment on": [
        (PWL, "    return slopes[seg]\n",
         "    return slopes[torch.clamp(seg + 1, max=len(slopes) - 1)]\n")],
    "tie 1/2 dropped": [
        (PWL, "return inside + 0.5 * ((x == lo)", "return inside + 1.0 * ((x == lo)"),
        (PWL, "(v > floor).to(torch.float32) + 0.5 *", "(v > floor).to(torch.float32) + 1.0 *"),
        (QUANT, "(amax > 1e-12).to(torch.float32) + 0.5 *",
         "(amax > 1e-12).to(torch.float32) + 1.0 *")],
    "tie split dropped": [
        (QUANT, "g_amax / count(hit)", "g_amax"),
        (SOFTMAX, "keepdim=True) / ties.sum(dim=-1, keepdim=True)", "keepdim=True)")],
    "softmax row-max term dropped": [
        (SOFTMAX, "share = -g_z.sum(dim=-1, keepdim=True) / ties.sum(dim=-1, keepdim=True)",
         "share = 0.0")],
    "rsqrt odd-exponent 1/2 dropped": [
        (NORM, "g_v = torch.where(odd, g_v * 0.5, g_v)", "g_v = g_v")],
    "layernorm mean term dropped": [
        (NORM, "g_d = g_d + (-g_d.sum(dim=-1, keepdim=True)) / n", "g_d = g_d")],
    "MMU x-scale path dropped": [
        (MMU, "return (g_p * ws).sum().reshape(x_scale.shape),",
         "return 0.0 * (g_p * ws).sum().reshape(x_scale.shape),")],
}
WORKER = r'''
import json, sys
from pathlib import Path
tree, out, stage = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
sys.path[:0] = [str(tree), str(tree / "src")]
import numpy as np, torch
torch.set_num_threads(4)
torch.set_float32_matmul_precision("highest")
import chip_smoke as cs
if stage == "base":
    (out / "plain.json").write_text(json.dumps(cs.train_route_cpu(str(out))))
else:
    plain = json.loads((out / "plain.json").read_text())
    cfg, opt, batch = cs.train_route_setup()
    res = {}
    for mode in ("npe-16bit", "npe-8bit"):
        got = cs.train_route_step(cs.MODES[mode](cfg), opt, batch, cs.route_model(cfg))
        with np.load(out / f"{mode}.npz") as z:
            want = {k: torch.from_numpy(z[k]) for k in z.files}
        r = cs.train_route_compare(mode, opt, got, want, plain[mode])
        res[mode] = dict(ok=r["ok"], shares=r["worst_share_of_gate"],
                         nonzero_same=r["nonzero_same"])
    print(json.dumps(res))
'''


def copy_tree(dst: Path, edits):
    shutil.rmtree(dst, ignore_errors=True)
    (dst / "src").mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", dst)
    shutil.copytree(ROOT / "src/repro_torch", dst / "src/repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, text, new in edits:
        path = dst / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise SystemExit(f"{rel}: the text to replace is not there once: {text!r}")
        path.write_text(src.replace(text, new))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True, help="a directory outside the repository")
    work = Path(ap.parse_args().work).resolve()
    if work == ROOT or ROOT in work.parents:
        sys.exit("--work must lie outside the repository")
    work.mkdir(parents=True, exist_ok=True)
    worker = work / "worker.py"
    worker.write_text(WORKER)
    base = work / "plain"
    base.mkdir(exist_ok=True)
    run = lambda tree, stage: subprocess.run(
        [sys.executable, str(worker), str(tree), str(base), stage],
        check=True, capture_output=True, text=True).stdout
    run(ROOT, "base")
    trees = {"no fault": ROOT}
    for i, (name, edits) in enumerate(FAULTS.items()):
        trees[name] = work / f"fault{i}"
        copy_tree(trees[name], edits)
    for name, tree in trees.items():
        res = json.loads(run(tree, "got").strip().splitlines()[-1])
        for mode, r in res.items():
            shares = ", ".join(f"{t} {v:.3g}" for t, v in r["shares"].items())
            same = "" if r["nonzero_same"] is None else f"; nonzero set same {r['nonzero_same']}"
            print(f"{name:32s} {mode:10s} {'passes' if r['ok'] else 'FAILS '} the gates; "
                  f"worst share of gate: {shares}{same}", flush=True)


if __name__ == "__main__":
    main()

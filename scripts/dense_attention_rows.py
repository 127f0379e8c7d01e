"""The dense mode's forward and backward at the shapes of chip_smoke.py [3],
on the card, for one or more checkouts of the repository side by side.

    python3 scripts/dense_attention_rows.py [--part forward|backward] [TREE ...]

Each TREE (default: this checkout) is a directory holding a `src/` of the
port, such as a `git archive` of another commit unpacked into an ignored
directory.  The shapes are this checkout's chip_smoke.py tables (DENSE_ROWS
and MASK_ROWS for the forward, ATTN_GRAD_ROWS for the backward), read from
its source, so that every tree is timed at the same rows.  For each tree in
turn (each in a process of its own, building its own kernels), it prints
the device ms a call of `dense_attention` (PWL and exact) and of
`dense_attention_grad` (from the forward's row statistics where the tree's
wrapper takes them) by torch.profiler, with the CUDA-event ms beside, as
that tree's chip_smoke.py `measure` takes them, and for the backward each
kernel's share (device ms a call by kernel).  Give a tree twice to see
the spread between runs of the same code: parent, change, change, parent.
Needs the card.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TABLES = ("DENSE_ROWS", "MASK_ROWS", "ATTN_GRAD_ROWS")


def tables() -> dict:
    """chip_smoke.py's row tables, from its source (no import: the trees
    timed may hold other versions of the port)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in TABLES}


def rows(tree: Path, part: str, t: dict) -> None:
    """The rows of one tree, in this process, timed by that tree's
    chip_smoke.py (which puts the tree's own src/ first on the path)."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _kernel_times, measure
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def operand(b, s, h, d):   # the models' layout: (B, H, S, D) views of (B, S, H, D)
        return torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)

    stats = "with_stats" in fa.dense_attention.__code__.co_varnames
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"tree {tree} ({'row statistics' if stats else 'no row statistics'}) on {card}",
          flush=True)
    forward = [(name, b, hq, hkv, sq, skv, kv_len, d, True, 0, 0.0)
               for name, b, hq, hkv, sq, skv, kv_len, d, _ in t["DENSE_ROWS"]]
    forward += [(name, b, hq, hkv, sq, skv, kv_len, d, causal, window, cap)
                for name, b, hq, hkv, sq, skv, kv_len, d, _, causal, window, cap in t["MASK_ROWS"]]
    for name, b, hq, hkv, sq, skv, kv_len, d, causal, window, cap in (
            forward if part != "backward" else []):
        q, k, v = operand(b, sq, hq, d), operand(b, skv, hkv, d), operand(b, skv, hkv, d)
        shape = f"{name} ({b}, {hq}/{hkv}, {sq}, {d}) kv {kv_len}/{skv}"
        for pwl in (True, False):
            kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=cap, use_pwl=pwl,
                      out_dtype=torch.bfloat16)
            ms, ev = measure(lambda: fa.dense_attention(q, k, v, **kw))
            print(f"  forward  {shape:44s} {'pwl  ' if pwl else 'exact'} {ms:.4f} ms "
                  f"(events {ev:.4f})", flush=True)
    for name, b, hq, hkv, sq, skv, d, causal, window, cap, pwl, _ in (
            t["ATTN_GRAD_ROWS"] if part != "forward" else []):
        q, k, v, do = (operand(b, sq, hq, d), operand(b, skv, hkv, d), operand(b, skv, hkv, d),
                       operand(b, sq, hq, d))
        kw = dict(causal=causal, window=window, softcap=cap, use_pwl=pwl)
        if stats:
            _, st = fa.dense_attention(q, k, v, with_stats=True, **kw)
            kw["stats"] = st
        ms, ev = measure(lambda: fa.dense_attention_grad(q, k, v, do, **kw), reps=10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fa.dense_attention_grad(q, k, v, do, **kw)
            torch.cuda.synchronize()
        split = ", ".join(f"{n.replace('void (anonymous namespace)::', '').split('(')[0]} "
                          f"{us / 1e4:.4f}"
                          for n, us, _ in _kernel_times(prof, with_counts=True))
        shape = f"{name} ({b}, {hq}/{hkv}, {sq}, {d}) kv {skv} w {window} cap {cap:g}"
        print(f"  backward {shape:44s} {'pwl  ' if pwl else 'exact'} {ms:.4f} ms "
              f"(events {ev:.4f}; {split})", flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        rows(Path(args[1]).resolve(), args[2], json.loads(args[3]))
        return 0
    part = "both"
    if args[:1] == ["--part"]:
        part, args = args[1], args[2:]
    t = json.dumps(tables())
    for tree in [Path(a).resolve() for a in args] or [ROOT]:
        if subprocess.run([sys.executable, __file__, "--one", str(tree), part, t]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

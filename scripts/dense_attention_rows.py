"""The dense mode's forward and backward, and the NVU softmax's backward, at
the shapes of chip_smoke.py [3], on the card, for one or more checkouts of
the repository side by side.

    python3 scripts/dense_attention_rows.py [--part PART] [--out DIR] [TREE ...]

PART: forward, backward, both (the default), decode (the forward's rows
that the decode instance takes: at most 8 rows a kv head), softmax_grad
(`nvu_softmax_grad`) or nvu_grad (`pwl_eval_grad` and
`nvu_layernorm_grad`).  Each TREE (default: this checkout) is a directory
holding a `src/` of the port, such as a `git archive` of another commit
unpacked into an ignored directory.  The shapes are this checkout's
chip_smoke.py tables (DENSE_ROWS and MASK_ROWS for the forward,
ATTN_GRAD_ROWS for the backward, SOFTMAX_GRAD_ROWS for the softmax's,
PWL_GRAD_ROWS and LN_GRAD_ROWS for nvu_grad), read from its source, so
that every tree is timed at the same rows.  The results of the
backward kernels of each tree are saved under DIR (default
chiprun_out/rows) and held to the first tree's with torch.equal (exit 1 if
any differs), the layernorm backward's (dx, dgamma, dbeta) within
chip_smoke.py's `grad_check` gate in place of torch.equal; nvu_grad's
files are removed once compared.  For each tree in
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
TABLES = ("DENSE_ROWS", "MASK_ROWS", "ATTN_GRAD_ROWS", "SOFTMAX_GRAD_ROWS",
          "PWL_GRAD_ROWS", "LN_GRAD_ROWS")
DECODE_ROWS = 8     # rows a kv head the decode instance takes
GRAD_RTOL, BF16_RTOL = 2e-5, 2.0 ** -7   # chip_smoke.py's grad_check gate


def tables() -> dict:
    """chip_smoke.py's row tables, from its source (no import: the trees
    timed may hold other versions of the port)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in TABLES}


def rows(tree: Path, part: str, t: dict, out: Path) -> None:
    """The rows of one tree, in this process, timed by that tree's
    chip_smoke.py (which puts the tree's own src/ first on the path); the
    softmax backward's results saved to `out`."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _kernel_times, measure
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvu_layernorm as ln
    from repro_torch.kernels import nvu_softmax as sm
    from repro_torch.kernels import pwl_eval as pe
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
    if part == "decode":
        forward = [r for r in forward if r[0] != "training forward"
                   and (r[2] // r[3]) * r[4] <= DECODE_ROWS]
    for name, b, hq, hkv, sq, skv, kv_len, d, causal, window, cap in (
            forward if part in ("forward", "both", "decode") else []):
        q, k, v = operand(b, sq, hq, d), operand(b, skv, hkv, d), operand(b, skv, hkv, d)
        shape = f"{name} ({b}, {hq}/{hkv}, {sq}, {d}) kv {kv_len}/{skv}"
        for pwl in (True, False):
            kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=cap, use_pwl=pwl,
                      out_dtype=torch.bfloat16)
            ms, ev = measure(lambda: fa.dense_attention(q, k, v, **kw))
            print(f"  forward  {shape:44s} {'pwl  ' if pwl else 'exact'} {ms:.4f} ms "
                  f"(events {ev:.4f})", flush=True)
    for name, b, hq, hkv, sq, skv, d, causal, window, cap, pwl, _ in (
            t["ATTN_GRAD_ROWS"] if part in ("backward", "both") else []):
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
    results = {}
    for n_rows, n, scale, dy_dtype in (t["SOFTMAX_GRAD_ROWS"] if part == "softmax_grad" else []):
        x = torch.randn(n_rows, n, generator=g, device=dev) * 3
        dy = torch.randn(n_rows, n, generator=g, device=dev).to(
            torch.bfloat16 if dy_dtype == "bf16" else torch.float32)
        results[f"{n_rows}x{n}"] = sm.nvu_softmax_grad(x, dy, scale=scale)
        ms, ev = measure(lambda: sm.nvu_softmax_grad(x, dy, scale=scale))
        print(f"  softmax backward ({n_rows}, {n}) scale {scale:g} dy {dy_dtype:4s} {ms:.4f} ms "
              f"(events {ev:.4f})", flush=True)
    for name, m, n, _ in (t["PWL_GRAD_ROWS"] if part == "nvu_grad" else []):
        x = (torch.randn(m, n, generator=g, device=dev) * 4).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        results[f"pwl {name} {m}x{n}"] = pe.pwl_eval_grad(x, dy, name)
        ms, ev = measure(lambda: pe.pwl_eval_grad(x, dy, name))
        print(f"  pwl_eval_grad ({m}, {n}) {name:4s} {ms:.4f} ms (events {ev:.4f})", flush=True)
    for m, n, eps, rms, _ in (t["LN_GRAD_ROWS"] if part == "nvu_grad" else []):
        x = (torch.randn(m, n, generator=g, device=dev) * 3 + 0.7).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        gam = 1 + 0.1 * torch.randn(n, generator=g, device=dev)
        got = ln.nvu_layernorm_grad(x, dy, gam, eps=eps, rms_only=rms)
        for k, v in zip(("dx", "dgamma", "dbeta"), got):
            if v is not None:
                results[f"ln {m}x{n} {k}"] = v
        ms, ev = measure(lambda: ln.nvu_layernorm_grad(x, dy, gam, eps=eps, rms_only=rms))
        print(f"  nvu_layernorm_grad ({m}, {n}){' rms' if rms else '    '} {ms:.4f} ms "
              f"(events {ev:.4f})", flush=True)
    if results:
        torch.save({k: v.cpu() for k, v in results.items()}, out)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        rows(Path(args[1]).resolve(), args[2], json.loads(args[3]), Path(args[4]))
        return 0
    part, out = "both", ROOT / "chiprun_out" / "rows"
    while args[:1] in (["--part"], ["--out"]):
        if args[0] == "--part":
            part = args[1]
        else:
            out = Path(args[1]).resolve()
        args = args[2:]
    out.mkdir(parents=True, exist_ok=True)
    t = json.dumps(tables())
    saved = []
    for i, tree in enumerate([Path(a).resolve() for a in args] or [ROOT]):
        saved.append(out / f"{part}_{i}.pt")
        if subprocess.run([sys.executable, __file__, "--one", str(tree), part, t,
                           str(saved[-1])]).returncode:
            return 1
    if part in ("softmax_grad", "nvu_grad"):
        import torch
        first = torch.load(saved[0])
        bad = False
        for i, path in enumerate(saved[1:], 1):
            same = {k: held(k, v, first[k]) for k, v in torch.load(path).items()}
            print(f"results of tree {i} against tree 0's (torch.equal; the layernorm's within "
                  f"grad_check's gate): {same}", flush=True)
            bad = bad or not all(same.values())
        if part == "nvu_grad":
            for path in saved:
                path.unlink()
        if bad:
            return 1
    return 0


def held(key: str, got, want) -> bool:
    """torch.equal, or for the layernorm backward chip_smoke.py's
    grad_check gate: GRAD_RTOL of the largest value, plus one bf16 rounding
    of each value of a bf16 dx."""
    if not key.startswith("ln "):
        return bool(got.equal(want))
    g, w = got.float(), want.float()
    gate = GRAD_RTOL * float(w.abs().max()) + (BF16_RTOL * w.abs() if key.endswith("dx") else 0.0)
    return bool(((g - w).abs() <= gate).all())


if __name__ == "__main__":
    sys.exit(main())

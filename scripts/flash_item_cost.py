"""Fixed and per-chunk cost of the tensor-core flash-attention instance.

    python3 scripts/flash_item_cost.py

Times `repro_torch.kernels.flash_attention` (bf16, D=64, 16-row query
tiles, so the tensor-core instance) on one block and on 96 blocks, over 1 to
4 KV blocks of 128-key chunks, with exact and PWL exp, plus the prefill and
several-blocks rows of `chip_smoke.py`: device us per call by torch.profiler
(chip_smoke's `measure`).  A one-block launch shows the fixed cost of a
launch (Q staging, first copies, the final combine); the growth with the
number of chunks shows the cost of each staged chunk.  Needs the card.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import card_info, measure  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CASES = [  # label, b, h, sq, skv, kv_len, causal, block_q, block_kv
    ("1 block, 16 keys (1 K + 1 V chunk)", 1, 1, 16, 128, 16, True, 256, 256),
    ("1 block, 128 keys (1 + 1 chunks)", 1, 1, 16, 128, 128, False, 256, 128),
    ("1 block, 512 keys, 1 KV block (4 + 4)", 1, 1, 16, 512, 512, False, 256, 512),
    ("1 block, 512 keys, 4 KV blocks (4 x (1 + 1))", 1, 1, 16, 512, 512, False, 256, 128),
    ("96 blocks, 512 keys, 1 KV block (4 + 4)", 8, 12, 16, 512, 512, False, 256, 512),
    ("prefill (1, 12, 128) kv 128", 1, 12, 128, 256, 128, True, 256, 256),
    ("several blocks (2, 12, 64) kv 512", 2, 12, 64, 512, 512, True, 64, 256),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_item_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card_info()}")
    for use_pwl in (False, True):
        print(f"exp: {'PWL' if use_pwl else 'exact'}  (device us per call)")
        for label, b, h, sq, skv, kv_len, causal, bq, bkv in CASES:
            def make(s):
                x = torch.randn(b, s, h, 64, generator=g, device=dev)
                return x.to(torch.bfloat16).permute(0, 2, 1, 3)
            q, k, v = make(sq), make(skv), make(skv)
            kw = dict(causal=causal, use_pwl=use_pwl, block_q=bq, block_kv=bkv,
                      kv_len=kv_len, out_dtype=torch.bfloat16)
            ms, _ = measure(lambda: fa.flash_attention(q, k, v, **kw), reps=50)
            print(f"  {label:46s} {1e3 * ms:8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

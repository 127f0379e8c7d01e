"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module has a public wrapper that launches the CUDA kernel for a
tensor on the card and runs the plain version for a tensor on the CPU.  The
wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
nowhere else, so a run can show that it went through the kernels.  The
backward kernels of the training path (the derivative mode of `pwl_eval`,
the backward passes of `nvu_softmax` and `nvu_layernorm`, and that of
flash attention's dense mode) count under their own names,
`<kernel>_grad`; the MMU's backward relaunches `quant_matmul`, which
counts as `quant_matmul`.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("pwl_eval", "quant_matmul", "nvu_softmax", "nvu_layernorm",
           "flash_attention", "pwl_eval_grad", "nvu_softmax_grad",
           "nvu_layernorm_grad", "flash_attention_grad")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)

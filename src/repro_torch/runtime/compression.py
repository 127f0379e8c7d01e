"""Int8 error-feedback gradient compression (counterpart of
`repro/runtime/compression.py`): each gradient quantized to int8 with one
scale, max|g + e| / 127, and dequantized, the residual carried as the next
error.  The same symmetric int8 quantization the MMU applies to its
activations, on the training's communication path."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.quant import _qmax_tensor


def init_error(params) -> Any:
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)


@torch.no_grad()
def compress_decompress(grads, error) -> Tuple[Any, Any]:
    """Returns (decompressed grads, new error feedback)."""

    def one(g, e):
        gf = g.to(torch.float32) + e
        amax = torch.clamp(gf.abs().amax(), min=1e-12)
        scale = amax / _qmax_tensor(8, gf.device)
        q = torch.clamp(torch.round(gf / scale), -128, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), gf - deq

    out = [one(g, e) for g, e in zip(T.leaves(grads), T.leaves(error))]
    return (T.unflatten(grads, [o[0] for o in out]),
            T.unflatten(grads, [o[1] for o in out]))

"""The MMU's number formats in plain torch (counterpart of `repro/core/quant.py`).

Symmetric linear quantization: per-tensor activation scales, per-output-
column weight scales, integer products accumulated exactly, dequantized as
`acc * (x_scale * w_scale)`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch


class QTensor(NamedTuple):
    """Symmetric-quantized tensor: values in int8/int16, float32 scale."""
    q: torch.Tensor        # int8 or int16
    scale: torch.Tensor    # f32; per tensor () or per channel (keepdim)

    @property
    def bits(self) -> int:
        return 8 if self.q.dtype == torch.int8 else 16

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


_QDTYPE = {8: torch.int8, 16: torch.int16}


@functools.lru_cache(maxsize=None)
def _qmax_tensor(bits: int, device: torch.device) -> torch.Tensor:
    """2^(bits-1) - 1 as a 0-dim float32 tensor on `device`.  On the card a
    Python-number divisor becomes a multiply by its reciprocal, one ulp off
    the quotient now and then; a tensor divisor is divided by."""
    return torch.tensor(float(2 ** (bits - 1) - 1), dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, bits: int = 8,
             axis: Optional[int] = None) -> QTensor:
    """Symmetric quantization; `axis` is the channel axis of per-channel
    scales (None: per tensor).  torch.round rounds half to even, as jnp does,
    and amax and x are divided (amax / qmax, x / scale), not multiplied by a
    reciprocal, on the CPU and the card alike."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        red = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
        amax = xf.abs().amax(dim=red, keepdim=True)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(amax, min=1e-12) / _qmax_tensor(bits, xf.device)
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax).to(_QDTYPE[bits])
    return QTensor(q, scale)


def quantize_scale_grad(x: torch.Tensor, g_scale: torch.Tensor, bits: int = 8,
                        axis: Optional[int] = None) -> torch.Tensor:
    """d/dx through `quantize(x, bits, axis)` given d/d(scale): the rounded
    values carry no gradient (round and the int cast have none), so this is
    the scale's path alone, as jax.grad of the reference's `quantize` gives
    it.  scale = max(amax, 1e-12) / qmax: g_scale / qmax (1/2 of it where
    amax ties 1e-12), to the entries of |x| that reach amax (of the tensor,
    or of each channel along `axis`) with x's sign (+ at 0, as jax's abs),
    split evenly among tied maxima.  The result has x's dtype."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
        count = lambda hit: hit.sum()
    else:
        red = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
        amax = xf.abs().amax(dim=red, keepdim=True)
        count = lambda hit: hit.sum(dim=red, keepdim=True)
    floor = (amax > 1e-12).to(torch.float32) + 0.5 * (amax == 1e-12).to(torch.float32)
    g_amax = g_scale.reshape(amax.shape) / _qmax_tensor(bits, xf.device) * floor
    hit = xf.abs() == amax
    share = torch.where(hit, g_amax / count(hit), 0.0)
    return torch.where(xf >= 0, share, -share).to(x.dtype)


# Float32 bytes of a weight's columns quantized at once: the quantizer holds
# a few float32 copies of what it quantizes, and those of a whole tied head
# (262144 x 5376: 5.6 GB each) do not fit beside a 27 B model on one card.
QUANT_CHUNK_BYTES = 1 << 30


def _column_chunks(w: torch.Tensor):
    """Column slices of a (K, N) weight, each at most QUANT_CHUNK_BYTES of
    float32."""
    cols = max(1, QUANT_CHUNK_BYTES // (4 * w.shape[0]))
    return [slice(c, min(c + cols, w.shape[1])) for c in range(0, w.shape[1], cols)]


def quantize_columns(w: torch.Tensor, bits: int = 8) -> QTensor:
    """`quantize(w, bits, axis=1)` of a (K, N) weight, a chunk of columns at
    a time: each column's scale depends on that column alone, so the values
    and scales are the same, with float32 temporaries of one chunk."""
    chunks = _column_chunks(w)
    if len(chunks) == 1:
        return quantize(w, bits, axis=1)
    q = torch.empty(w.shape, dtype=_QDTYPE[bits], device=w.device)
    scale = torch.empty(1, w.shape[1], dtype=torch.float32, device=w.device)
    for c in chunks:
        part = quantize(w[:, c], bits, axis=1)
        q[:, c], scale[:, c] = part.q, part.scale
    return QTensor(q, scale)


def fake_quantize(x: torch.Tensor, bits: int = 8,
                  axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize, straight-through in the backward pass."""
    y = quantize(x, bits, axis).dequantize().to(x.dtype)
    return x + (y - x).detach()


def int_matmul(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """Integer matmul (..., M, K) @ (K, N) with exact int32 results.

    Accumulates in float64, which holds every integer below 2^53 and has a
    matmul on the CPU and the card alike.  A float32 product would not be
    exact: at K=3072 the sums reach 127^2 * 3072 > 2^24."""
    return torch.matmul(aq.to(torch.float64), bq.to(torch.float64)).to(torch.int32)


def quant_dense(x: torch.Tensor, w: QTensor, bias: Optional[torch.Tensor] = None,
                act_bits: int = 8, act_axis: Optional[int] = None) -> torch.Tensor:
    """The MMU primitive: quantize activations, integer matmul, dequantize."""
    dt = x.dtype
    xa = quantize(x, act_bits, axis=act_axis)
    acc = int_matmul(xa.q, w.q)
    out = acc.to(torch.float32) * (xa.scale * w.scale.reshape(1, -1))
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dt)


def dense_maybe_quant(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      npe_quant: bool = False, bits: int = 8,
                      act_axis: Optional[int] = None) -> torch.Tensor:
    """Dense layer through the MMU when the NPE mode is on.

    At 8 bits: int8 x int8 products into int32.  At 16 bits: fake-quantization
    to the int16 grid with a float32 product, as the reference models it,
    taken over chunks of the weight's columns (`_column_chunks`), each
    fake-quantized on its own: the same values, with float32 temporaries of
    one chunk."""
    if not npe_quant:
        return x @ w if bias is None else x @ w + bias
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if bits == 8:
        wq = quantize(w, bits, axis=1)
        y = quant_dense(x2, wq, bias, act_bits=bits, act_axis=act_axis)
    else:
        xq = fake_quantize(x2.to(torch.float32), bits, axis=act_axis)
        y = torch.cat([xq @ fake_quantize(w[:, c].to(torch.float32), bits, axis=1)
                       for c in _column_chunks(w)], dim=-1)
        if bias is not None:
            y = y + bias.to(torch.float32)
        y = y.to(x.dtype)
    return y.reshape(*lead, w.shape[1])

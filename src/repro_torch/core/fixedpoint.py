"""The NVU's fixed-point formats in plain torch (counterpart of
`repro/core/fixedpoint.py`, paper §4.1.3 / §5.5).

A Q-format has `bits` in all, sign included, and `frac` fractional bits.
Values are carried in float32 (float64 when the input is float64) holding
exact multiples of 2^-frac: each operation rounds half to even onto the
grid and saturates to the format's range, which models the FPGA datapath
bit for bit wherever the intermediates fit in the carrier's mantissa.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class QFormat:
    bits: int   # total bits, including sign
    frac: int   # fractional bits

    @property
    def scale(self) -> float:
        return float(2.0 ** self.frac)

    @property
    def max_val(self) -> float:
        return (2.0 ** (self.bits - 1) - 1) / self.scale

    @property
    def min_val(self) -> float:
        return -(2.0 ** (self.bits - 1)) / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def __str__(self) -> str:
        return f"Q{self.bits}.{self.frac}"


# The formats of the NVU datapath (paper §6.5: 8/16/32/64-bit).
Q8_4 = QFormat(8, 4)
Q16_8 = QFormat(16, 8)      # activations entering the NVU (MMU output)
Q16_12 = QFormat(16, 12)
Q32_16 = QFormat(32, 16)    # intermediate arithmetic
Q32_24 = QFormat(32, 24)
Q64_32 = QFormat(64, 32)    # variance accumulations (53-bit-exact model)


def quantize(x: torch.Tensor, qf: QFormat) -> torch.Tensor:
    """Round half to even onto the Q-grid and saturate; the result holds the
    dequantized values in float32 (float64 for a float64 input)."""
    x = torch.as_tensor(x)
    carrier = torch.float64 if x.dtype == torch.float64 else torch.float32
    scaled = torch.round(x.to(carrier) * qf.scale)
    lo = -(2.0 ** (qf.bits - 1))
    hi = 2.0 ** (qf.bits - 1) - 1
    return torch.clamp(scaled, lo, hi) / qf.scale


def fixed_add(a, b, out: QFormat) -> torch.Tensor:
    return quantize(a + b, out)


def fixed_sub(a, b, out: QFormat) -> torch.Tensor:
    return quantize(a - b, out)


def fixed_mul(a, b, out: QFormat) -> torch.Tensor:
    return quantize(a * b, out)


def fixed_sum(x: torch.Tensor, axis: int, out: QFormat) -> torch.Tensor:
    """The VCU adder tree: a float32 sum, kept as a dimension, then quantized."""
    return quantize(x.to(torch.float32).sum(dim=axis, keepdim=True), out)


def fixed_mean(x: torch.Tensor, axis: int, out: QFormat) -> torch.Tensor:
    n = x.shape[axis]
    return quantize(x.to(torch.float32).sum(dim=axis, keepdim=True) / n, out)

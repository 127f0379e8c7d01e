"""The flash kernel's number plan, checked on the CPU before the card runs it.

`csrc/flash_attention.cu` picks an instance by dtype and shape (its source
note): f32 K/V on the CUDA cores; bf16 K/V with at most 8 query rows a kv
head (decode) on the CUDA cores in f32; bf16 K/V with more rows on the bf16
tensor cores.  The tensor-core instance multiplies bf16 pieces: q*scale,
rounded to f32 as in the reference, is split into three bf16 pieces (one
when q is bf16 and scale a power of two), and the f32 probabilities p into
three bf16 pieces before P.V.  A bf16 x bf16 product is exact in f32.

Here that plan is emulated in float64 (the exact products of the pieces,
summed and rounded once to f32, as an f32 accumulator would at best) around
the reference's blocked online softmax, and held to `flash_attention_plain`
within half of the tolerance that the kernel must meet on the card
(tests/test_torch_cuda_kernels.py: 2e-5 absolute and relative).  Both sides
are compared in f32, before any bf16 output rounding, which is common to
both.  Cases: every shape of FLASH_CASES, in both PWL settings, with each
dtype set that the card tests run.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import nvu
from repro_torch.kernels.flash_attention import (NEG_BIG, _exp, block_runs,
                                                 flash_attention_plain)
from test_torch_cuda_kernels import FLASH_CASES

KERNEL_TOL = 2e-5          # atol and rtol of the f32 card tests
DECODE_ROWS = 8            # rows a kv head that the decode instance takes
P_PIECES = 3               # bf16 pieces of p before P.V


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def split(x: torch.Tensor, pieces: int):
    """x (f32) as bf16 pieces: x = sum(pieces) exactly for three."""
    out, r = [], x
    for _ in range(pieces - 1):
        hi = _bf16(r)
        out.append(hi)
        r = r - hi               # exact in f32
    out.append(_bf16(r))
    return out


def q_pieces(q_dtype: torch.dtype, scale: float) -> int:
    return 1 if q_dtype == torch.bfloat16 and math.frexp(scale)[0] == 0.5 else 3


def products(a_pieces, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i @ b in float64 (exact products of bf16 values), rounded to f32."""
    return sum(a.double() @ b.double() for a in a_pieces).float()


def emulate(q, k, v, *, causal, window, use_pwl, block_q, block_kv, kv_len):
    """The kernel's arithmetic in float64 around `_flash_kernel`'s blocking."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5
    mma = k.dtype == torch.bfloat16 and (hq // hkv) * sq > DECODE_ROWS
    nq = q_pieces(q.dtype, scale) if mma else 1
    kk = k.repeat_interleave(hq // hkv, dim=1).float()
    vv = v.repeat_interleave(hq // hkv, dim=1).float()
    qs = q.float() * scale                       # rounded to f32, as the reference
    qp = split(qs, nq) if mma else [qs]
    if mma and nq == 1:
        assert torch.equal(qp[0], qs)            # q*scale is itself a bf16
    off = kv_len - sq
    out = torch.empty(b, hq, sq, d)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        rows = torch.arange(q0, q1)[:, None] + off
        m = torch.full((b, hq, q1 - q0, 1), NEG_BIG)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hq, q1 - q0, d)
        for k0 in range(0, kv_len, block_kv):
            if not block_runs(off + q0, off + q1 - 1, k0, block_kv, kv_len, causal, window):
                continue
            k1 = min(k0 + block_kv, kv_len)
            s = products([p[:, :, q0:q1] for p in qp], kk[:, :, k0:k1].transpose(-1, -2))
            cols = torch.arange(k0, k1)[None, :]
            mask = torch.ones_like(s, dtype=torch.bool)
            if causal:
                mask = mask & (cols <= rows)
            if window > 0:
                mask = mask & (cols > rows - window)
            s = torch.where(mask, s, NEG_BIG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = _exp(m - m_new, use_pwl, 16)
            p = torch.where(mask, _exp(s - m_new, use_pwl, 16), 0.0)
            pv = products(split(p, P_PIECES) if mma else [p], vv[:, :, k0:k1])
            l = corr * l + p.double().sum(dim=-1, keepdim=True).float()
            acc = corr * acc + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        inv = nvu.nvu_reciprocal(l, 16) if use_pwl else 1.0 / l
        out[:, :, q0:q1] = acc * inv
    return out


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_number_plan_within_half_the_card_tolerance(case, use_pwl, q_dtype, kv_dtype):
    b, hq, hkv, sq, skv, d, kv_len, causal, window, bq, bkv = case
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, hq, sq, d), np.float32)).to(q_dtype)
    k = torch.from_numpy(rng.standard_normal((b, hkv, skv, d), np.float32)).to(kv_dtype)
    v = torch.from_numpy(rng.standard_normal((b, hkv, skv, d), np.float32)).to(kv_dtype)
    kw = dict(causal=causal, window=window, use_pwl=use_pwl, block_q=bq, block_kv=bkv,
              kv_len=kv_len)
    got = emulate(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw)
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 0.5 * KERNEL_TOL * (1 + want.abs())).all()), float(err.max())


def test_three_pieces_are_exact():
    """The split that the tensor-core instance uses loses nothing."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    x = torch.cat([x, x * 1e-20, x * 1e20, torch.rand(64)])
    assert torch.equal(sum(p.double() for p in split(x, 3)).float(), x)
    assert all(torch.equal(_bf16(p), p) for p in split(x, 3))

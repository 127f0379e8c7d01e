"""Each kernel's plain PyTorch version against the reference oracle
(`repro.kernels.ref`) and the Pallas kernel run in interpret mode
(`repro.kernels.ops`), at small shapes.

Tolerances are those of tests/test_kernels.py: the plain versions evaluate
the PWL by gather and the Pallas kernels in prefix-delta form, which differ
by float32 rounding (pwl 1e-5 in f32 and 2e-2 in bf16, quant_matmul 1e-5,
softmax 2e-5, layernorm 3e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pwl as ref_pwl
from repro.core.quant import quantize as ref_quantize
from repro.kernels import ops as pallas
from repro.kernels import ref
from repro_torch.core import pwl
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.nvu_layernorm import nvu_layernorm, nvu_layernorm_plain
from repro_torch.kernels.nvu_softmax import nvu_softmax_plain, nvu_softmax_walk
from repro_torch.kernels.pwl_eval import pwl_eval, pwl_eval_plain
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["gelu", "exp"])
def test_pwl_eval_plain(fn, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    x = torch.from_numpy(_x((33, 130), scale=4.0)).to(getattr(torch, dtype))
    got = pwl_eval_plain(x, pwl.get_table(fn, 16))
    assert got.dtype == x.dtype
    xf = jnp.asarray(x.float().numpy())
    _close(got.float(), ref.pwl_eval(xf, ref_pwl.get_table(fn, 16)), tol)
    _close(got.float(), pallas.pwl_activation(xf.astype(getattr(jnp, dtype)), fn), tol)
    assert torch.equal(pwl_eval(x, fn), got)   # the wrapper's CPU route


@pytest.mark.parametrize("m,k,n", [(8, 128, 64), (100, 300, 70)])
@pytest.mark.parametrize("activation", [None, "gelu"])
def test_quant_matmul_plain(m, k, n, activation):
    x, w = _x((m, k), 1), _x((k, n), 2) / np.sqrt(k)
    xq, wq = ref_quantize(jnp.asarray(x), 8), ref_quantize(jnp.asarray(w), 8, axis=1)
    args = [torch.from_numpy(np.array(a)) for a in (xq.q, wq.q, xq.scale, wq.scale)]
    table = pwl.get_table(activation, 16) if activation else None
    got = quant_matmul_plain(*args, table=table)
    ref_table = ref_pwl.get_table(activation, 16) if activation else None
    _close(got, ref.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, table=ref_table), 1e-5)
    _close(got, pallas.quant_matmul(jnp.asarray(x), jnp.asarray(w), activation=activation,
                                    block_m=min(256, max(8, m)), block_n=128,
                                    block_k=128), 1e-5)
    assert torch.equal(quant_matmul(*args, activation=activation), got)


@pytest.mark.parametrize("rows,cols,causal", [(8, 128, False), (100, 512, False),
                                              (128, 128, True)])
def test_nvu_softmax_plain(rows, cols, causal):
    x = _x((rows, cols), 3, scale=3.0)
    got = nvu_softmax_plain(torch.from_numpy(x), causal_rows=rows if causal else 0)
    _close(got, ref.nvu_softmax(jnp.asarray(x), causal=causal), 2e-5)
    _close(got, pallas.softmax(jnp.asarray(x), causal=causal, block_rows=64), 2e-5)
    assert torch.equal(ops.softmax(torch.from_numpy(x), causal=causal), got)


@pytest.mark.parametrize("rows,cols,causal", [(8, 128, False), (128, 128, True)])
@pytest.mark.parametrize("scale", [0.125, 32 ** -0.5])
def test_nvu_softmax_plain_scale_and_bf16_output(rows, cols, causal, scale):
    """The scale multiplies x before the max, once, in f32; a bf16 output is
    the f32 result rounded to nearest even: nvu_softmax_plain(x * scale)
    .to(bfloat16) bit for bit, and within the f32 gate (2e-5) and one bf16
    ulp of the oracle on the scaled scores."""
    x = _x((rows, cols), 9, scale=20.0)
    xt = torch.from_numpy(x)
    cr = rows if causal else 0
    got = nvu_softmax_plain(xt, causal_rows=cr, scale=scale, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, nvu_softmax_plain(xt * scale, causal_rows=cr).to(torch.bfloat16))
    f32 = nvu_softmax_plain(xt, causal_rows=cr, scale=scale)
    assert f32.dtype == torch.float32
    assert torch.equal(f32, nvu_softmax_plain(xt * scale, causal_rows=cr))
    want = np.asarray(ref.nvu_softmax(jnp.asarray(x * np.float32(scale)), causal=causal))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=2e-5)
    assert torch.equal(ops.softmax(xt, causal=causal, scale=scale, out_dtype=torch.bfloat16),
                       got)


@pytest.mark.parametrize("rows,cols,causal", [(8, 128, 0), (100, 512, 0), (96, 40, 16),
                                              (64, 1000, 0)])
def test_nvu_softmax_walk_close_to_plain(rows, cols, causal):
    """The kernel's arithmetic in torch ops (its order of addition, the
    walk, the reciprocal's bit trick) against the plain version: float32
    rounding apart (2e-5)."""
    x = torch.from_numpy(_x((rows, cols), 10, scale=3.0))
    for scale, dt in ((1.0, torch.float32), (0.125, torch.bfloat16)):
        got = nvu_softmax_walk(x, causal_rows=causal, scale=scale, out_dtype=dt)
        want = nvu_softmax_plain(x, causal_rows=causal, scale=scale, out_dtype=dt)
        assert got.dtype == dt
        tol = 2e-5 if dt == torch.float32 else 2.0 ** -7
        _close(got.float(), want.float(), tol)


def test_nvu_softmax_plain_causal_batched():
    """Causal over (..., q, k) with q < k: each matrix is masked on its own,
    the last query aligned with the last key, as the oracle has it."""
    x = _x((2, 3, 16, 40), 4, scale=3.0)
    got = ops.softmax(torch.from_numpy(x), causal=True)
    _close(got, ref.nvu_softmax(jnp.asarray(x), causal=True), 2e-5)


@pytest.mark.parametrize("rows,cols,rms", [(16, 768, False), (3, 256, True)])
def test_nvu_layernorm_plain(rows, cols, rms):
    x = _x((rows, cols), 5, scale=3.0) + 0.7
    g = 1 + 0.1 * _x((cols,), 6)
    b = 0.1 * _x((cols,), 7)
    eps = 1e-6 if rms else 1e-5
    tg, tb = torch.from_numpy(g), None if rms else torch.from_numpy(b)
    got = nvu_layernorm_plain(torch.from_numpy(x), tg, tb, eps=eps, rms_only=rms)
    _close(got, ref.nvu_layernorm(jnp.asarray(x), jnp.asarray(g),
                                  None if rms else jnp.asarray(b), eps=eps,
                                  rms_only=rms), 3e-5)
    want = (pallas.rmsnorm(jnp.asarray(x), jnp.asarray(g)) if rms else
            pallas.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    _close(got, want, 3e-5)
    assert torch.equal(nvu_layernorm(torch.from_numpy(x), tg, tb, eps=eps,
                                     rms_only=rms), got)


def test_cpu_route_counts_no_launches():
    before = dict(LAUNCHES)
    x = torch.from_numpy(_x((4, 64), 8))
    ops.pwl_activation(x, "gelu")
    ops.softmax(x)
    ops.layernorm(x, torch.ones(64), torch.zeros(64))
    ops.quant_dense(x, torch.from_numpy(_x((64, 32), 9)))
    assert LAUNCHES == before

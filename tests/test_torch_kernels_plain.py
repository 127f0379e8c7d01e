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


# --- per-row MMU scales and the softmax key limit (the npec executor's) ---

@pytest.mark.parametrize("m,k,n", [(1, 128, 64), (8, 128, 64), (8, 768, 64), (100, 300, 70)])
def test_quant_matmul_plain_row_scales(m, k, n):
    """(M, 1) activation scales: the reference's quant_dense(act_axis=0),
    bit for bit, through the plain version, the wrapper's CPU route and
    `ops.quant_dense(act_axis=0)` (the reference's dense_maybe_quant)."""
    from repro.core.quant import dense_maybe_quant as ref_dense
    from repro.core.quant import quant_dense as ref_quant_dense
    from repro_torch.core.quant import quantize
    x, w = _x((m, k), 4, scale=2.0) * _x((m, 1), 5, scale=3.0), _x((k, n), 6) / np.sqrt(k)
    wq_ref = ref_quantize(jnp.asarray(w), 8, axis=1)
    want = np.asarray(ref_quant_dense(jnp.asarray(x), wq_ref, act_axis=0))
    xq = quantize(torch.from_numpy(x), 8, axis=0)
    wq = quantize(torch.from_numpy(w), 8, axis=1)
    assert xq.scale.shape == (m, 1)
    assert np.array_equal(xq.q.numpy(), np.asarray(ref_quantize(jnp.asarray(x), 8, axis=0).q))
    got = quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(quant_matmul(xq.q, wq.q, xq.scale, wq.scale), got)
    dense = ops.quant_dense(torch.from_numpy(x), torch.from_numpy(w), act_axis=0)
    assert np.array_equal(dense.numpy(), np.asarray(ref_dense(
        jnp.asarray(x), jnp.asarray(w), npe_quant=True, bits=8, act_axis=0)))


def test_quant_matmul_plain_equal_row_scales_are_the_tensor_scale():
    x, w = _x((8, 128), 7), _x((128, 64), 8) / 12
    xq, wq = ref_quantize(jnp.asarray(x), 8), ref_quantize(jnp.asarray(w), 8, axis=1)
    a, b, xs, ws = (torch.from_numpy(np.array(t)) for t in (xq.q, wq.q, xq.scale, wq.scale))
    rows = xs.reshape(1, 1).expand(8, 1).contiguous()
    assert torch.equal(quant_matmul_plain(a, b, rows, ws), quant_matmul_plain(a, b, xs, ws))
    with pytest.raises(ValueError, match="scales"):
        quant_matmul(a, b, xs.reshape(1).expand(3).contiguous(), ws)


def _limits(rows, cols, per, seed):
    """Visible-column counts in [0, cols], one for each `per` rows, with a
    row that sees every column and one that sees none."""
    lim = np.random.default_rng(seed).integers(0, cols + 1, rows // per)
    lim[0], lim[-1] = cols, 0
    return torch.from_numpy(lim.astype(np.int32))


@pytest.mark.parametrize("rows,cols,per", [(96, 256, 8), (96, 256, 1), (40, 1000, 1),
                                           (33, 64, 1), (24, 32, 3)])
def test_nvu_softmax_plain_and_walk_with_limit(rows, cols, per):
    """Row r sees columns c < its limit: the reference's
    core.nvu.nvu_softmax(where=) within one f32 ulp per column of the row,
    masked entries exactly 0 and rows with no visible column all 0."""
    from repro.core import nvu as ref_nvu
    from repro_torch.kernels.nvu_softmax import limit_mask
    x = _x((rows, cols), 9, scale=6.0)
    limit = _limits(rows, cols, per, 10)
    where = limit_mask(limit, rows, cols)
    want = np.asarray(ref_nvu.nvu_softmax(jnp.asarray(x), where=jnp.asarray(where.numpy())))
    tol = cols * np.finfo(np.float32).eps
    for fn in (nvu_softmax_plain, nvu_softmax_walk):
        got = fn(torch.from_numpy(x), limit=limit)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        assert bool((got[~where] == 0).all())
        empty = ~where.any(dim=1)
        assert bool(empty.any()) and bool((got[empty] == 0).all())
    assert torch.equal(ops.softmax(torch.from_numpy(x), limit=limit.repeat_interleave(per)),
                       nvu_softmax_plain(torch.from_numpy(x), limit=limit))


def test_ops_softmax_limit_broadcasts():
    """The executor's masks through ops.softmax: one limit for each (q, n)
    matrix (decode, last axis 1) and one a row (a chunked slice)."""
    from repro.core import nvu as ref_nvu
    x = _x((3, 2, 16), 11, scale=4.0)
    got = ops.softmax(torch.from_numpy(x), limit=torch.tensor([7], dtype=torch.int32))
    where = np.arange(16) < 7
    want = ref_nvu.nvu_softmax(jnp.asarray(x), where=jnp.asarray(np.broadcast_to(where, x.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=16 * 1.2e-7)
    pos = torch.tensor([3, 4], dtype=torch.int32)
    got = ops.softmax(torch.from_numpy(x), limit=pos + 1)
    where = np.arange(16)[None, :] <= pos.numpy()[:, None]
    want = ref_nvu.nvu_softmax(jnp.asarray(x), where=jnp.asarray(np.broadcast_to(where, x.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=16 * 1.2e-7)


def test_nvu_softmax_limit_refusals():
    from repro_torch.kernels.nvu_softmax import nvu_softmax
    x = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="limits for 8 rows"):
        nvu_softmax(x, limit=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="together"):
        nvu_softmax(x, causal_rows=8, limit=torch.ones(8, dtype=torch.int32))


@pytest.mark.parametrize("segments", [8, 16])
def test_causal_by_limit_is_not_the_oracles_causal_mode(segments):
    """The executor's causal softmax (`where`, masked scores out of the max
    and 0 before the sum) is not the oracle's causal mode (-1e30, exp taken
    at the -18 clamp), even on a square matrix: they differ wherever the
    table's exp at -18 is not 0 (8 segments: 2.4e-5) and agree where it is
    (16 segments)."""
    from repro.core import nvu as ref_nvu
    x = _x((2, 64, 64), 12, scale=3.0)
    flat = torch.from_numpy(x.reshape(-1, 64))
    limit = (torch.arange(128) % 64 + 1).to(torch.int32)
    by_limit = nvu_softmax_plain(flat, segments, limit=limit)
    by_rows = nvu_softmax_plain(flat, segments, causal_rows=64)
    where = np.broadcast_to(np.tril(np.ones((64, 64), bool)), x.shape)
    want = ref_nvu.nvu_softmax(jnp.asarray(x), segments=segments, where=jnp.asarray(where))
    np.testing.assert_allclose(by_limit.numpy().reshape(x.shape), np.asarray(want), rtol=0,
                               atol=64 * np.finfo(np.float32).eps)
    assert torch.equal(by_limit, by_rows) == (segments == 16)
    assert torch.equal(nvu_softmax_walk(flat, segments, limit=limit) != 0,
                       by_limit != 0)

"""The port's MMU semantics (`repro_torch.core.quant`) against `repro.core.quant`.

Quantized values, scales and integer products must be equal; dequantized
outputs agree within 1e-6, the rounding of one float32 product."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as ref
from repro_torch.core import quant
from repro_torch.kernels import ops

ATOL = 1e-6


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 1, 0])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_equal(axis, bits):
    x = _x((64, 96))
    want = ref.quantize(jnp.asarray(x), bits, axis=axis)
    got = quant.quantize(torch.from_numpy(x), bits, axis=axis)
    assert got.q.dtype == {8: torch.int8, 16: torch.int16}[bits]
    assert got.bits == bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_quantize_rounds_half_to_even():
    """With amax 127 the scale is 1, so 0.5, 1.5 and 2.5 are exact ties."""
    x = torch.tensor([0.0, 0.5, 1.5, 2.5, 127.0])
    q = quant.quantize(x, 8).q
    np.testing.assert_array_equal(q.numpy(), [0, 0, 2, 2, 127])


def test_int_matmul_exact():
    """K=3072 with extreme values: sums beyond 2^24 stay exact."""
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (33, 3072)).astype(np.int8)
    b = rng.integers(-128, 128, (3072, 17)).astype(np.int8)
    a[0] = -128
    b[:, 0] = -128
    got = quant.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref.int_matmul(jnp.asarray(a), jnp.asarray(b))))


def test_fake_quantize():
    x = _x((32, 48), seed=2)
    want = ref.fake_quantize(jnp.asarray(x), 16, axis=1)
    got = quant.fake_quantize(torch.from_numpy(x), 16, axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("act_axis", [None, 0])
def test_quant_dense(act_axis):
    x, w, b = _x((24, 128), 3), _x((128, 40), 4, 0.1), _x((40,), 5, 0.1)
    wq_ref = ref.quantize(jnp.asarray(w), 8, axis=1)
    want = ref.quant_dense(jnp.asarray(x), wq_ref, jnp.asarray(b), act_axis=act_axis)
    wq = quant.quantize(torch.from_numpy(w), 8, axis=1)
    got = quant.quant_dense(torch.from_numpy(x), wq, torch.from_numpy(b),
                            act_axis=act_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("npe", [False, True])
def test_dense_maybe_quant(bits, npe):
    x, w, b = _x((2, 12, 128), 6), _x((128, 40), 7, 0.1), _x((40,), 8, 0.1)
    want = ref.dense_maybe_quant(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 npe_quant=npe, bits=bits)
    got = quant.dense_maybe_quant(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), npe_quant=npe, bits=bits)
    assert got.shape == (2, 12, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL if npe else 1e-5)


def test_ops_quant_dense_is_the_8bit_mmu():
    """The kernel route's wrapper computes exactly what dense_maybe_quant does."""
    x, w = torch.from_numpy(_x((3, 10, 128), 9)), torch.from_numpy(_x((128, 40), 10, 0.1))
    got = ops.quant_dense(x, w)
    want = quant.dense_maybe_quant(x, w, npe_quant=True, bits=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [8, 16])
def test_column_chunks_quantize_as_the_whole(monkeypatch, bits):
    """A weight quantized a chunk of columns at a time (7 columns a chunk
    here; a tied 262144-column head on the card) gives the whole weight's
    values and scales; the 8-bit MMU's and the 16-bit product's results
    are those of the unchunked weight (the 16-bit one within ATOL: its
    float32 product is taken a chunk at a time)."""
    w = torch.from_numpy(_x((64, 100), seed=5))
    x = torch.from_numpy(_x((6, 64), seed=6))
    whole = quant.quantize(w, bits, axis=1)
    mmu8 = ops.quant_dense(x, w)
    mmu16 = quant.dense_maybe_quant(x, w, npe_quant=True, bits=16)
    monkeypatch.setattr(quant, "QUANT_CHUNK_BYTES", 7 * 64 * 4)
    assert len(quant._column_chunks(w)) == 15
    got = quant.quantize_columns(w, bits)
    assert torch.equal(got.q, whole.q) and torch.equal(got.scale, whole.scale)
    assert torch.equal(ops.quant_dense(x, w), mmu8)
    np.testing.assert_allclose(quant.dense_maybe_quant(x, w, npe_quant=True, bits=16).numpy(),
                               mmu16.numpy(), rtol=0, atol=ATOL * float(mmu16.abs().max()))

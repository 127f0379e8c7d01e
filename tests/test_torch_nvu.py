"""The port's NVU (`repro_torch.core.nvu`) against `repro.core.nvu`, float mode.

Both compute the same f32 operations; reductions may sum in another order,
so outputs agree within 1e-6 absolute (1e-6 relative where values span
1e-20..1e20)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nvu as ref
from repro.core import pwl as ref_pwl
from repro_torch.core import nvu, pwl

ATOL = 1e-6


def _x(shape, seed=0, scale=4.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["exp", "gelu", "recip", "rsqrt"])
@pytest.mark.parametrize("clamped", [False, True])
def test_pwl_eval(name, clamped):
    x = _x((37, 53), scale=8.0)
    if name in ("recip", "rsqrt"):
        x = np.abs(x) / 16 + 0.25
    f, rf = (nvu.pwl_eval_clamped, ref.pwl_eval_clamped) if clamped else \
        (nvu.pwl_eval, ref.pwl_eval)
    _close(f(torch.from_numpy(x), pwl.get_table(name, 16)),
           rf(jnp.asarray(x), ref_pwl.get_table(name, 16)))


def test_pwl_eval_bf16():
    x = torch.from_numpy(_x((16, 64))).to(torch.bfloat16)
    got = nvu.pwl_eval(x, pwl.get_table("gelu", 16))
    assert got.dtype == torch.bfloat16
    want = ref.pwl_eval(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                        ref_pwl.get_table("gelu", 16))
    _close(got.float(), np.asarray(want, np.float32))


@pytest.mark.parametrize("fn", ["nvu_reciprocal", "nvu_rsqrt"])
@pytest.mark.parametrize("segments", [16, 32])
def test_mantissa_normalized(fn, segments):
    """frexp/ldexp over 1e-20..1e20: odd and even exponents, both signs."""
    x = np.logspace(-20, 20, 401, dtype=np.float32)
    got = getattr(nvu, fn)(torch.from_numpy(x), segments)
    want = getattr(ref, fn)(jnp.asarray(x), segments)
    _close(got, want, atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("fn", ["nvu_gelu", "nvu_exp"])
def test_elementwise(fn):
    x = _x((64, 96), seed=1, scale=6.0)
    if fn == "nvu_exp":
        x = -np.abs(x) * 4
    _close(getattr(nvu, fn)(torch.from_numpy(x)), getattr(ref, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax(masked):
    x = _x((2, 3, 16, 48), seed=2, scale=3.0)
    where = None
    if masked:
        rng = np.random.default_rng(3)
        where = rng.random(x.shape) > 0.3
        where[0, 0, 0] = False            # an all-masked row gives zeros
    got = nvu.nvu_softmax(torch.from_numpy(x), where=None if where is None
                          else torch.from_numpy(where))
    want = ref.nvu_softmax(jnp.asarray(x), where=None if where is None
                           else jnp.asarray(where))
    _close(got, want)
    if masked:
        assert float(got[0, 0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("bias", [False, True])
def test_layernorm(eps, bias):
    x = _x((24, 128), seed=4, scale=3.0) + 0.7
    g = 1 + 0.1 * _x((128,), seed=5, scale=1.0)
    b = 0.1 * _x((128,), seed=6, scale=1.0) if bias else None
    got = nvu.nvu_layernorm(torch.from_numpy(x), torch.from_numpy(g),
                            None if b is None else torch.from_numpy(b), eps=eps)
    want = ref.nvu_layernorm(jnp.asarray(x), jnp.asarray(g),
                             None if b is None else jnp.asarray(b), eps=eps)
    _close(got, want)


@pytest.mark.parametrize("use_pwl", [False, True])
def test_activation_and_softmax_dispatch(use_pwl):
    x = _x((8, 128), seed=7)
    _close(nvu.activation("gelu", use_pwl)(torch.from_numpy(x)),
           ref.activation("gelu", use_pwl)(jnp.asarray(x)))
    _close(nvu.softmax(torch.from_numpy(x), use_pwl=use_pwl),
           ref.softmax(jnp.asarray(x), use_pwl=use_pwl))

"""The whole NVU of the port against the reference's: the fixed-point
formats (`repro_torch.core.fixedpoint`), every PWL table of `_FUNCS` under
every segmentation strategy, and every NVU function in float and fixed mode
(`repro_torch.core.nvu`), plus the model-facing wrappers `ops.rmsnorm` and
`ops.pwl_activation`.

Tolerances:
  * `quantize`, `fixed_add/sub/mul` and the tables: bit for bit (the same
    IEEE operations, elementwise, and the same numpy code);
  * `fixed_sum/mean` on inputs that lie on a Q-grid: bit for bit (such sums
    are exact in float32, whatever the order);
  * float-mode functions: 1e-6 absolute, as tests/test_torch_nvu.py (the
    same f32 operations; reductions may add in another order);
  * fixed-mode functions: elementwise ones bit for bit; softmax, layernorm
    and rmsnorm, whose float32 reductions may add in another order before
    the result is rounded onto a Q-grid, within one step of the output
    grid, with at least 99% of the values equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as ref_fp
from repro.core import nvu as ref
from repro.core import pwl as ref_pwl
from repro_torch.core import fixedpoint as fp
from repro_torch.core import nvu, pwl
from repro_torch.kernels import KERNELS, LAUNCHES, ops, reset_launches

FORMATS = ["Q8_4", "Q16_8", "Q16_12", "Q32_16", "Q32_24", "Q64_32"]
ELEMENTWISE = ["gelu", "tanh", "sigmoid", "silu", "erf", "softplus", "exp_neg_exp", "relu2"]
ATOL = 1e-6


def _x(shape, seed=0, scale=4.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _within_one_step(got: torch.Tensor, want, step: float) -> None:
    g, w = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    diff = np.abs(g - w)
    assert diff.max() <= step * (1 + 1e-6), diff.max()
    assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("name", FORMATS)
def test_qformat_fields(name):
    got, want = getattr(fp, name), getattr(ref_fp, name)
    assert (got.bits, got.frac, str(got)) == (want.bits, want.frac, str(want))
    assert (got.scale, got.max_val, got.min_val, got.resolution) == \
        (want.scale, want.max_val, want.min_val, want.resolution)


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_bit_for_bit(name):
    """Round half to even, saturation at both ends, ties included."""
    qf = getattr(fp, name)
    x = np.concatenate([_x((4096,), seed=1, scale=8.0),
                        _x((512,), seed=2, scale=1e6),
                        np.arange(-64, 64, dtype=np.float32) / (2 * qf.scale),   # exact ties
                        np.array([0.0, -0.0, 1e30, -1e30], np.float32)])
    got = fp.quantize(torch.from_numpy(x), qf)
    assert got.dtype == torch.float32
    _same(got, ref_fp.quantize(jnp.asarray(x), getattr(ref_fp, name)))


def test_quantize_carriers():
    """float64 stays float64 (on the grid to 2^-32 where float32 cannot);
    bf16 and float32 go to float32."""
    x = np.array([1.0 + 2.0 ** -30, -3.3e9, 7.5e-10])
    got = fp.quantize(torch.from_numpy(x), fp.Q64_32)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.clip(np.round(x * 2.0 ** 32), -2.0 ** 63,
                                                       2.0 ** 63 - 1) / 2.0 ** 32)
    assert fp.quantize(torch.ones(3, dtype=torch.bfloat16), fp.Q16_8).dtype == torch.float32


@pytest.mark.parametrize("op", ["fixed_add", "fixed_sub", "fixed_mul"])
@pytest.mark.parametrize("name", ["Q16_8", "Q32_16"])
def test_fixed_elementwise_ops(op, name):
    a, b = _x((64, 33), seed=3), _x((64, 33), seed=4)
    got = getattr(fp, op)(torch.from_numpy(a), torch.from_numpy(b), getattr(fp, name))
    _same(got, getattr(ref_fp, op)(jnp.asarray(a), jnp.asarray(b), getattr(ref_fp, name)))


@pytest.mark.parametrize("op", ["fixed_sum", "fixed_mean"])
@pytest.mark.parametrize("axis", [0, -1])
def test_fixed_reductions_on_the_grid(op, axis):
    x = np.array(ref_fp.quantize(jnp.asarray(_x((48, 128), seed=5)), ref_fp.Q16_8))
    got = getattr(fp, op)(torch.from_numpy(x), axis, fp.Q32_16)
    want = getattr(ref_fp, op)(jnp.asarray(x), axis, ref_fp.Q32_16)
    assert tuple(got.shape) == want.shape
    _same(got, want)


@pytest.mark.parametrize("strategy", ["uniform", "adaptive", "adaptive+lsq"])
@pytest.mark.parametrize("segments", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(ref_pwl._FUNCS))
def test_every_table_bit_for_bit(name, segments, strategy):
    want = ref_pwl.get_table(name, segments, strategy)
    got = pwl.get_table(name, segments, strategy)
    for field in want._fields:
        g = getattr(got, field)
        assert g.dtype == np.float32, field
        np.testing.assert_array_equal(g, np.asarray(getattr(want, field)), err_msg=field)


def test_table_catalog_and_tools():
    assert pwl.available_functions() == ref_pwl.available_functions()
    assert pwl._TAILS == ref_pwl._TAILS
    assert {k: v[1:] for k, v in pwl._FUNCS.items()} == \
        {k: v[1:] for k, v in ref_pwl._FUNCS.items()}
    f = lambda x: np.tanh(x)                                     # noqa: E731
    for got, want in ((pwl.uniform_table(f, -2.0, 2.0, 7), ref_pwl.uniform_table(f, -2.0, 2.0, 7)),
                      (pwl.adaptive_table(f, -2.0, 2.0, 5, lsq_refine=False),
                       ref_pwl.adaptive_table(f, -2.0, 2.0, 5, lsq_refine=False))):
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
    xs = np.linspace(-70000.0, 70000.0, 1001)
    for name in ("silu", "exp", "sqrt"):
        t, rt = pwl.get_table(name, 16), ref_pwl.get_table(name, 16)
        np.testing.assert_array_equal(pwl.eval_pwl_np(t, xs), ref_pwl.eval_pwl_np(rt, xs))
        fn = pwl._FUNCS[name][0]
        assert pwl.table_max_error(fn, t) == ref_pwl.table_max_error(fn, rt)
    with pytest.raises(KeyError):
        pwl.get_table("cosh")
    with pytest.raises(ValueError):
        pwl.get_table("silu", 16, "greedy")


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("segments", [8, 16])
@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise(name, segments, fixed):
    """Inside and far outside each table's interval, both signs."""
    x = np.concatenate([_x((4096,), seed=6, scale=6.0), _x((64,), seed=7, scale=200.0)])
    got = getattr(nvu, f"nvu_{name}")(torch.from_numpy(x), segments=segments, fixed=fixed)
    want = getattr(ref, f"nvu_{name}")(jnp.asarray(x), segments=segments, fixed=fixed)
    if fixed:
        _same(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_elementwise_bf16_fixed():
    x = torch.from_numpy(_x((32, 64), seed=8)).to(torch.bfloat16)
    got = nvu.nvu_silu(x, fixed=True)
    assert got.dtype == torch.bfloat16
    want = ref.nvu_silu(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), fixed=True)
    _same(got.float(), np.asarray(want, np.float32))


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax(fixed, masked):
    x = _x((3, 16, 96), seed=9, scale=3.0)
    where = None
    if masked:
        where = np.random.default_rng(10).random(x.shape) > 0.3
        where[0, 0] = False                       # an all-masked row gives zeros
    got = nvu.nvu_softmax(torch.from_numpy(x), fixed=fixed,
                          where=None if where is None else torch.from_numpy(where))
    want = ref.nvu_softmax(jnp.asarray(x), fixed=fixed,
                           where=None if where is None else jnp.asarray(where))
    if fixed:
        _within_one_step(got, want, fp.Q16_12.resolution)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if masked:
        assert float(got[0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_layernorm(fixed, bias):
    x = _x((24, 256), seed=11, scale=3.0) + 0.7
    g = 1 + 0.1 * _x((256,), seed=12, scale=1.0)
    b = 0.1 * _x((256,), seed=13, scale=1.0) if bias else None
    got = nvu.nvu_layernorm(torch.from_numpy(x), torch.from_numpy(g),
                            None if b is None else torch.from_numpy(b), fixed=fixed)
    want = ref.nvu_layernorm(jnp.asarray(x), jnp.asarray(g),
                             None if b is None else jnp.asarray(b), fixed=fixed)
    if fixed:
        _within_one_step(got, want, fp.Q16_8.resolution)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm(fixed, eps):
    x = _x((24, 512), seed=14, scale=2.0)
    g = 1 + 0.1 * _x((512,), seed=15, scale=1.0)
    got = nvu.nvu_rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps=eps, fixed=fixed)
    want = ref.nvu_rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=eps, fixed=fixed)
    if fixed:
        _within_one_step(got, want, fp.Q16_8.resolution)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("name", sorted(ref._EXACT))
def test_activation_dispatch(name, use_pwl):
    """`activation` for every name the reference dispatches, exact and PWL
    (exact functions within 1e-6 relative: libm and XLA may differ by ulps)."""
    assert sorted(nvu._EXACT) == sorted(ref._EXACT) and sorted(nvu._NVU) == sorted(ref._NVU)
    x = _x((16, 128), seed=16, scale=3.0)
    got = nvu.activation(name, use_pwl)(torch.from_numpy(x))
    want = np.asarray(ref.activation(name, use_pwl)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("name", sorted(ref_pwl._FUNCS))
def test_pwl_activation_every_table(name):
    """The model-facing wrapper: every table through the `pwl_eval` kernel's
    plain version (edge segments extrapolate, as the reference's
    `nvu.pwl_eval`); relu2 by max and multiply, as `nvu_relu2`."""
    x = _x((2, 8, 96), seed=17, scale=6.0)
    got = ops.pwl_activation(torch.from_numpy(x), name)
    assert got.shape == x.shape
    if name == "relu2":
        want = ref.nvu_relu2(jnp.asarray(x))
    else:
        want = ref.pwl_eval(jnp.asarray(x), ref_pwl.get_table(name, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", [n for n in ELEMENTWISE if n != "relu2"])
def test_pwl_activation_is_the_nvu_function(name):
    """For finite inputs the extrapolating evaluation equals each NVU
    activation, clamped or not: the saturating tables' guard segments are
    flat."""
    x = np.concatenate([_x((1024,), seed=18, scale=8.0), np.array([-7e4, 7e4], np.float32)])
    got = ops.pwl_activation(torch.from_numpy(x)[None], name)[0]
    want = getattr(ref, f"nvu_{name}")(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_ops_rmsnorm_is_nvu_rmsnorm():
    """`ops.rmsnorm` (the layernorm kernel's rms_only route; its plain
    version here) against the reference's `nvu_rmsnorm` and its Pallas
    route `ops.rmsnorm`, at 4096 columns as GLM4-9B's norms; no launch
    counted on the CPU."""
    from repro.kernels import ops as ref_ops
    x = _x((2, 3, 4096), seed=19, scale=2.0)
    g = 1 + 0.1 * _x((4096,), seed=20, scale=1.0)
    reset_launches()
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps=1e-6)
    assert LAUNCHES == {k: 0 for k in KERNELS}
    want = ref.nvu_rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    pallas = ref_ops.rmsnorm(jnp.asarray(x[0]), jnp.asarray(g), eps=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas), rtol=1e-5, atol=3e-5)

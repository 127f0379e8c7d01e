"""The backward passes of the port's kernel ops (their plain backward on the
CPU) against jax.grad of the reference's jnp functions on the same inputs.

Each op is differentiated through `loss = sum(op(x) * w)` with w from a seed,
so every output's gradient is exercised.  The inputs hold the cases where
the reference's gradient has a rule of its own: points on the PWL knots, at
the clamp ends and past them (jnp.clip gives 1/2 at an end, 0 past it);
tied row maxima (the gradient splits evenly); fully masked softmax rows;
power-of-4 variances (the rsqrt mantissa ties its clip at 0.25); tied
absolute maxima of the MMU's activations and weight columns (NPE-8's only
gradient path is through its scales).

Tolerance: GRAD_RTOL = 1e-5 of the largest reference gradient of the case,
elementwise (the sums run in other orders); where the reference's gradient
is zero the port's must be zero too (the same set of nonzero entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nvu as ref_nvu
from repro.core import pwl as ref_pwl
from repro.core.quant import dense_maybe_quant as ref_dense
from repro_torch.core.quant import dense_maybe_quant
from repro_torch.kernels import ops

GRAD_RTOL = 1e-5

torch.set_float32_matmul_precision("highest")


def _rng(seed):
    return np.random.default_rng(seed)


def _check(got, want, nonzero_same=True):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    assert float(err.max()) <= GRAD_RTOL * scale, (float(err.max()), scale)
    if nonzero_same:
        np.testing.assert_array_equal(got != 0, want != 0)


def _torch_grad(fn, *arrays, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return [t.grad.to(torch.float32).numpy() for t in ts]


def _knot_points(name, extra=()):
    """The table's knots and their float32 neighbours (a knot at 0 gets
    +-1e-30 instead: XLA on the CPU flushes subnormals to zero, and the
    card does not)."""
    knots = np.asarray(ref_pwl.get_table(name, 16).knots, np.float32)
    pts = np.concatenate([knots, np.nextafter(knots, np.float32(-np.inf)),
                          np.nextafter(knots, np.float32(np.inf)), np.asarray(extra, np.float32)])
    tiny = (pts != 0) & (np.abs(pts) < np.finfo(np.float32).tiny)
    return np.where(tiny, np.sign(pts) * np.float32(1e-30), pts).astype(np.float32)


def _rows(v, cols=8):
    pad = (-len(v)) % cols
    return np.concatenate([v, np.zeros(pad, np.float32)]).reshape(-1, cols)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_grad(dtype):
    x = _rows(np.concatenate([_knot_points("gelu", (-7.0, 9.0, -70000.0, 70000.0)),
                              _rng(0).normal(0, 3, 64).astype(np.float32)]))
    w = _rng(1).normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.nvu_gelu(a).astype(jnp.float32) * w))(
        jnp.asarray(x).astype(jdt))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.pwl_activation(a, "gelu").float() * tw).sum(), x,
                       dtype=getattr(torch, dtype))
    _check(got, np.asarray(ref.astype(jnp.float32)))


def test_exp_grad():
    """nvu_exp = max(pwl_eval_clamped(x), 0): knots, the clamp ends at
    +-65536 and past them, positive x (the flat guard segment)."""
    x = _rows(np.concatenate([_knot_points("exp", (-65536.0, 65536.0, -1e6, 1e6, 0.5, 3.0)),
                              -np.abs(_rng(2).normal(0, 6, 64)).astype(np.float32)]))
    w = _rng(3).normal(size=x.shape).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.nvu_exp(a) * w))(jnp.asarray(x))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.pwl_exp(a) * tw).sum(), x)
    _check(got, np.asarray(ref))


def test_recip_table_grad_clamped():
    """The recip table in its clamped use, on and around its knots and past
    its ends 0.25 and 1 (the softmax's reciprocal of a mantissa)."""
    x = _rows(np.concatenate([_knot_points("recip", (0.1, 1.5, 0.5, 0.75)),
                              _rng(4).uniform(0.25, 1.0, 32).astype(np.float32)]))
    w = _rng(5).normal(size=x.shape).astype(np.float32)
    table = ref_pwl.get_table("recip", 16)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.pwl_eval_clamped(a, table) * w))(jnp.asarray(x))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.pwl_activation(a, "recip", clamped=True) * tw).sum(), x)
    _check(got, np.asarray(ref))


def test_rsqrt_grad():
    """nvu_rsqrt: powers of 4 (mantissa 0.25, the clip's tie), powers of 2,
    values whose mantissa sits on a knot, random positives."""
    knots = np.asarray(ref_pwl.get_table("rsqrt", 16).knots, np.float32)
    x = np.concatenate([4.0 ** np.arange(-4, 5), 2.0 ** np.arange(-5, 6), knots, knots * 4,
                        knots * 8, _rng(6).uniform(0.01, 50, 40)]).astype(np.float32)
    x = _rows(x)
    w = _rng(7).normal(size=x.shape).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.nvu_rsqrt(a) * w))(jnp.asarray(x))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.pwl_rsqrt(a) * tw).sum(), x)
    _check(got, np.asarray(ref))


def _scores(seed, rows=24, n=40):
    x = _rng(seed).normal(0, 3, (rows, n)).astype(np.float32)
    x[0, 3] = x[0, 7] = x[0].max() + 1.0           # a tied max
    x[1, :] = 2.5                                   # every column tied
    x[2, 5] = x[2, 9] = x[2, 11] = x[2].max() + 0.5
    return x


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.125, 32 ** -0.5])
def test_softmax_grad(out_dtype, scale):
    x = _scores(10)
    rows, n = x.shape
    w = _rng(11).normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(out_dtype)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.softmax(a * scale, use_pwl=True, segments=16)
                                     .astype(jdt).astype(jnp.float32) * w))(jnp.asarray(x))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.softmax(a, scale=scale, out_dtype=getattr(torch, out_dtype))
                                  .float() * tw).sum(), x)
    _check(got, np.asarray(ref))


def test_softmax_grad_masked():
    """The masked softmax (the reference's `where`, the port's `limit`):
    visible prefixes of each row, rows with nothing visible, a tie."""
    x = _scores(12)
    rows, n = x.shape
    limit = _rng(13).integers(1, n + 1, rows).astype(np.int32)
    limit[3] = 0
    limit[4] = 0
    limit[0] = n
    where = np.arange(n)[None, :] < limit[:, None]
    w = _rng(14).normal(size=x.shape).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.softmax(a, use_pwl=True, where=where) * w))(
        jnp.asarray(x))
    tw = torch.tensor(w)
    lim = torch.tensor(limit)
    got, = _torch_grad(lambda a: (ops.softmax(a, limit=lim) * tw).sum(), x)
    _check(got, np.asarray(ref))


def test_softmax_grad_causal():
    """causal=True masks each (q, n) matrix with the last query on the last
    key; its gradient is the reference's with that mask as `where`."""
    x = _rng(15).normal(0, 2, (2, 6, 10)).astype(np.float32)
    q, n = x.shape[1:]
    where = np.arange(n)[None, :] <= np.arange(q)[:, None] + (n - q)
    w = _rng(16).normal(size=x.shape).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(ref_nvu.softmax(a, use_pwl=True, where=where) * w))(
        jnp.asarray(x))
    tw = torch.tensor(w)
    got, = _torch_grad(lambda a: (ops.softmax(a, causal=True) * tw).sum(), x)
    _check(got, np.asarray(ref))


def _norm_rows(seed, n=16):
    x = _rng(seed).normal(0.3, 2, (12, n)).astype(np.float32)
    x[0] = np.tile([1.0, -1.0], n // 2)          # variance 1: v = 1 + eps rounds to 1 = 4^0
    x[1] = np.tile([2.0, -2.0], n // 2)          # variance 4
    x[2] = np.tile([0.5, -0.5], n // 2) + 3.0    # variance 1/4
    x[3] = np.tile([2.0, -2.0], n // 2) * 2 ** 0.5   # variance 8: an odd exponent
    return x


# 16 columns, and the trained widths: BERT-base's 768, Granite's 1024 and
# StarCoder2-3B's 3072
@pytest.mark.parametrize("n", [16, 768, 1024, 3072])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
def test_layernorm_grad(dtype, rms, n):
    x = _norm_rows(20, n)
    if rms:
        x[2] -= 3.0
    gamma = (1 + 0.1 * _rng(21).normal(size=n)).astype(np.float32)
    beta = (0.1 * _rng(22).normal(size=n)).astype(np.float32)
    w = _rng(23).normal(size=x.shape).astype(np.float32)
    eps = 1e-12 if not rms else 1e-6
    jdt = jnp.dtype(dtype)
    if rms:
        fn = lambda a, g, b: ref_nvu.nvu_rmsnorm(a, g, eps=eps)
    else:
        fn = lambda a, g, b: ref_nvu.nvu_layernorm(a, g, b, eps=eps)
    ref = jax.grad(lambda a, g, b: jnp.sum(fn(a, g, b).astype(jnp.float32) * w),
                   argnums=(0, 1, 2))(jnp.asarray(x).astype(jdt), jnp.asarray(gamma),
                                      jnp.asarray(beta))
    tw = torch.tensor(w)
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    gt = torch.tensor(gamma).requires_grad_(True)
    bt = torch.tensor(beta).requires_grad_(True)
    if rms:
        y = ops.rmsnorm(xt, gt, eps=eps)
    else:
        y = ops.layernorm(xt, gt, bt, eps=eps)
    (y.float() * tw).sum().backward()
    _check(xt.grad.float().numpy(), np.asarray(ref[0].astype(jnp.float32)), nonzero_same=False)
    _check(gt.grad.numpy(), np.asarray(ref[1]))
    if not rms:
        _check(bt.grad.numpy(), np.asarray(ref[2]))


def _tied_operands(seed, m=6, k=16, n=12):
    r = _rng(seed)
    x = r.normal(0, 1, (m, k)).astype(np.float32)
    amax = float(np.abs(x).max())
    x[1, 2], x[4, 9] = amax, -amax                 # tied |x| max, both signs
    wt = r.normal(0, k ** -0.5, (k, n)).astype(np.float32)
    for c in (0, 5):                               # tied column maxima
        cm = float(np.abs(wt[:, c]).max())
        wt[3, c], wt[11, c] = -cm, cm
    return x, wt


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("act_axis", [None, 0])
def test_dense_maybe_quant_grad(bits, act_axis):
    x, wt = _tied_operands(30)
    g = _rng(31).normal(size=(x.shape[0], wt.shape[1])).astype(np.float32)
    ref = jax.grad(lambda a, b: jnp.sum(ref_dense(a, b, npe_quant=True, bits=bits,
                                                  act_axis=act_axis) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wt))
    tg = torch.tensor(g)
    if bits == 8:
        fn = lambda a, b: (ops.quant_dense(a, b, act_axis=act_axis) * tg).sum()
    else:
        fn = lambda a, b: (dense_maybe_quant(a, b, npe_quant=True, bits=16, act_axis=act_axis)
                           * tg).sum()
    gx, gw = _torch_grad(fn, x, wt)
    _check(gx, np.asarray(ref[0]))
    _check(gw, np.asarray(ref[1]))
    if bits == 8:       # only the entries that set a scale carry gradient
        assert np.count_nonzero(gx) <= (x.shape[0] if act_axis == 0 else 2) * 2
        assert np.count_nonzero(gw) <= 2 * wt.shape[1]


def test_quant_dense_grad_bf16():
    """bf16 operands, whose |x| maxima tie often once rounded."""
    x, wt = _tied_operands(32, m=8, k=32, n=16)
    g = _rng(33).normal(size=(8, 16)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(wt).astype(jnp.bfloat16)
    ref = jax.grad(lambda a, b: jnp.sum(ref_dense(a, b, npe_quant=True, bits=8)
                                        .astype(jnp.float32) * g), argnums=(0, 1))(xb, wb)
    tg = torch.tensor(g)
    gx, gw = _torch_grad(lambda a, b: (ops.quant_dense(a, b).float() * tg).sum(), x, wt,
                         dtype=torch.bfloat16)
    _check(gx, np.asarray(ref[0].astype(jnp.float32)))
    _check(gw, np.asarray(ref[1].astype(jnp.float32)))

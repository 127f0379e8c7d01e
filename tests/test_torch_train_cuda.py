"""The backward kernels of the training path against their plain backward
passes on the card.  Needs an NVIDIA GPU and nvcc: marked `cuda`, skips
without a card.  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py

`pwl_eval_grad` multiplies the same float32 slope as its plain version does
(the table's own, found by the same segment rule): bit for bit.  The
softmax and norm backward kernels sum in another order than torch:
within GRAD_RTOL = 2e-5 of the largest value of the result, and a bf16
result may round to the neighbouring bf16 value (2^-7 of itself).  The
MMU's backward relaunches the forward kernel for its int32 product: its
scale gradients equal those from `int_matmul` within 1e-6 of their
largest value (the same products, summed by torch on each side).
"""
import pytest
import torch

from repro_torch.core.quant import quantize
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import nvu_layernorm as ln
from repro_torch.kernels import nvu_softmax as sm
from repro_torch.kernels import pwl_eval as pe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.core.pwl import get_table

pytestmark = pytest.mark.cuda

GRAD_RTOL = 2e-5
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _close(got, want, bf16=False):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    gate = GRAD_RTOL * float(w.abs().max()) + (BF16_RTOL * w.abs() if bf16 else 0)
    assert bool((err <= gate).all()), float(err.max())


def _counted(name, fn):
    before = LAUNCHES[name]
    out = fn()
    assert LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("name,clamped", [("gelu", False), ("exp", True), ("recip", True),
                                          ("rsqrt", True), ("silu", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 3), (1024, 3072)])
def test_pwl_eval_grad_bit_for_bit(dev, name, clamped, dtype, shape):
    g = _gen(dev)
    knots = torch.as_tensor(get_table(name, 16).knots, device=dev)
    x = torch.randn(shape, generator=g, device=dev) * 4
    flat = x.view(-1)
    flat[:knots.numel()] = knots[:flat.numel()]
    x = x.to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    got = _counted("pwl_eval_grad", lambda: pe.pwl_eval_grad(x, dy, name, clamped=clamped))
    want = pe.pwl_eval_grad_plain(x, dy, get_table(name, 16), clamped)
    assert got.dtype == dtype and torch.equal(got, want)


def _scores(dev, rows, n, seed=1):
    x = torch.randn(rows, n, generator=_gen(dev, seed), device=dev) * 3
    x[0, 3] = x[0, 7] = x[0].max() + 1          # tied maxima
    x[1] = 2.5                                  # a whole row tied
    return x


@pytest.mark.parametrize("rows,n", [(12288, 128), (96, 256), (40, 1000), (33, 64)])
@pytest.mark.parametrize("dy_dtype", [torch.float32, torch.bfloat16])
def test_nvu_softmax_grad(dev, rows, n, dy_dtype):
    x = _scores(dev, rows, n)
    dy = torch.randn(rows, n, generator=_gen(dev, 2), device=dev).to(dy_dtype)
    got = _counted("nvu_softmax_grad", lambda: sm.nvu_softmax_grad(x, dy, scale=0.125))
    _close(got, sm.nvu_softmax_grad_plain(x, dy, scale=0.125))


@pytest.mark.parametrize("mask", ["limit", "causal"])
def test_nvu_softmax_grad_masked(dev, mask):
    x = _scores(dev, 1280, 128, seed=3)
    dy = torch.randn(1280, 128, generator=_gen(dev, 4), device=dev)
    if mask == "limit":
        limit = torch.randint(0, 129, (1280,), generator=_gen(dev, 5), device=dev,
                              dtype=torch.int32)
        limit[5] = 0
        kw = dict(limit=limit)
    else:
        kw = dict(causal_rows=128)
    got = _counted("nvu_softmax_grad", lambda: sm.nvu_softmax_grad(x, dy, **kw))
    _close(got, sm.nvu_softmax_grad_plain(x, dy, **kw))


def _norm_rows(dev, rows, n, dtype):
    x = torch.randn(rows, n, generator=_gen(dev, 6), device=dev) * 2 + 0.3
    x[0] = torch.tensor([1.0, -1.0], device=dev).repeat(n // 2)       # variance 1 = 4^0
    x[1] = torch.tensor([2.0, -2.0], device=dev).repeat(n // 2) * 2 ** 0.5
    return x.to(dtype)


@pytest.mark.parametrize("rows,n", [(1024, 768), (8, 768), (64, 4096), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms_only", [False, True])
def test_nvu_layernorm_grad(dev, rows, n, dtype, rms_only):
    x = _norm_rows(dev, rows, n, dtype)
    dy = torch.randn(rows, n, generator=_gen(dev, 7), device=dev).to(dtype)
    gamma = 1 + 0.1 * torch.randn(n, generator=_gen(dev, 8), device=dev)
    eps = 1e-12 if not rms_only else 1e-6
    dx, dg, db = _counted("nvu_layernorm_grad",
                          lambda: ln.nvu_layernorm_grad(x, dy, gamma, eps, 16, rms_only))
    wx, wg, wb = ln.nvu_layernorm_grad_plain(x, dy, gamma, eps, 16, rms_only)
    assert dx.dtype == dtype
    _close(dx, wx, bf16=dtype == torch.bfloat16)
    _close(dg, wg)
    assert (db is None) == rms_only
    if not rms_only:
        _close(db, wb)


@pytest.mark.parametrize("m,k,n", [(1024, 768, 768), (1024, 3072, 768), (1024, 768, 30720),
                                   (8, 768, 3072)])
def test_quant_matmul_scale_grad(dev, m, k, n):
    g = _gen(dev, 9)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    xq, wq = quantize(x, 8), quantize(w, 8, axis=1)
    dy = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    got = _counted("quant_matmul", lambda: qm.quant_matmul_scale_grad(
        xq.q, wq.q, xq.scale, wq.scale, dy))
    want = qm.quant_matmul_scale_grad_plain(xq.q, wq.q, xq.scale, wq.scale, dy)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_ops_backward_on_the_card_matches_the_cpu(dev):
    """One layer's NPE ops (the MMU, softmax, LayerNorm, GELU) with autograd
    on the card against the same on the CPU (the plain backward passes)."""
    g = torch.Generator().manual_seed(10)
    x = torch.randn(64, 128, generator=g)
    w = torch.randn(128, 256, generator=g) / 128 ** 0.5
    gamma = 1 + 0.1 * torch.randn(256, generator=g)
    beta = 0.1 * torch.randn(256, generator=g)

    def run(device):
        xs = [t.to(device).requires_grad_(True) for t in (x, w, gamma, beta)]
        h = ops.quant_dense(xs[0], xs[1])
        h = ops.layernorm(h, xs[2], xs[3], eps=1e-12)
        h = ops.pwl_activation(h, "gelu")
        p = ops.softmax(h.reshape(64, 4, 64).float(), scale=0.125, out_dtype=torch.bfloat16)
        (p.float() * torch.linspace(-1, 1, 64, device=device)).sum().backward()
        return [t.grad.cpu() for t in xs]

    for a, b in zip(run(dev), run("cpu")):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()) + 1e-7, err

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

The dense mode's backward (`dense_attention_grad`, two kernels) against
`dense_attention_grad_plain` at every case of
`test_torch_dense_attention_grad.py` and at the model shapes of
`chip_smoke.py`'s rows (StarCoder2, Granite, GLM4, Gemma3 with a window and
a soft cap, Whisper's cross attention), by
`flash_attention.dense_attention_grad_gates`: within GRAD_RTOL = 1e-4 of
the largest value of each result or, where that is larger, twice the
plain version's own change when the score scale moves ceil(sqrt(D))
float32 ulps up or down, and for a bf16 result one bf16 ulp of each entry.
The kernel sums each score's D products in another order than torch's
product does, so the two scores differ by the rounding of D additions, up
to about sqrt(D) ulps: a bf16 probability or cotangent may round to its
neighbour, and where a row's top two scores lie that close, or a score
sits next to one of the exp table's knots, the PWL derivative jumps (by a
few percent of a row's gradient, through the row max's term), which the
scale nudge shows the plain version doing too.  (With a nudge of one ulp,
then of ceil(sqrt(D) / 2), Granite's dq came to 1.33 and then 1.01 times
the gate in PWL mode on the H100; every other shape stayed within 0.42.)
"""
import pytest
import torch

from repro_torch.core.quant import quantize
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nvu_layernorm as ln
from repro_torch.kernels import nvu_softmax as sm
from repro_torch.kernels import pwl_eval as pe
from repro_torch.kernels import quant_matmul as qm
from repro_torch.core.pwl import get_table

pytestmark = pytest.mark.cuda

GRAD_RTOL = 2e-5
BF16_RTOL = 2.0 ** -7
ATTN_GRAD_RTOL = fa.GRAD_RTOL


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


@pytest.mark.parametrize("name,shape", [("gelu", (4096, 12288)), ("silu", (40960, 512))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clamped", [False, True])
def test_pwl_eval_grad_model_shapes(dev, name, shape, dtype, clamped):
    """StarCoder2-3B's GELU and Granite's expert SiLU of a 4 x 1024 train
    step (chip_smoke.py's PWL_GRAD_ROWS), bit for bit."""
    g = _gen(dev, 10)
    x = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    got = _counted("pwl_eval_grad", lambda: pe.pwl_eval_grad(x, dy, name, clamped=clamped))
    assert torch.equal(got, pe.pwl_eval_grad_plain(x, dy, get_table(name, 16), clamped))


def _offset(t):
    """A contiguous copy of t one element into its storage: not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


@pytest.mark.parametrize("skew", ["x", "dy", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pwl_eval_grad_unaligned(dev, skew, dtype):
    """An x or dy that is not 16-byte aligned takes the scalar instance,
    bit for bit."""
    g = _gen(dev, 11)
    x = (torch.randn(96, 520, generator=g, device=dev) * 4).to(dtype)
    dy = torch.randn(96, 520, generator=g, device=dev).to(dtype)
    if skew in ("x", "both"):
        x = _offset(x)
    if skew in ("dy", "both"):
        dy = _offset(dy)
    for clamped in (False, True):
        got = _counted("pwl_eval_grad", lambda: pe.pwl_eval_grad(x, dy, "exp", clamped=clamped))
        assert torch.equal(got, pe.pwl_eval_grad_plain(x, dy, get_table("exp", 16), clamped))


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


# rows of 768 and 4096 (f32: past the warp instance's 2048 columns), 3072
# (bf16: the warp instance's widest class; f32: the block instance) and
# 8192 + 64 (the block instance reading the row again from global memory);
# (4096, 3072) and (4096, 1024), StarCoder2-3B's LayerNorm and Granite's
# RMSNorm of a 4 x 1024 train step; 100 columns (not 16-byte rows)
@pytest.mark.parametrize("rows,n", [(1024, 768), (8, 768), (64, 4096), (5, 100), (48, 3072),
                                    (33, 8256), (4096, 3072), (4096, 1024)])
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


@pytest.mark.parametrize("rows,n,dtype", [(1024, 768, torch.bfloat16),
                                          (4096, 3072, torch.bfloat16),
                                          (300, 3072, torch.float32),
                                          (33, 8256, torch.float32)])
@pytest.mark.parametrize("rms_only", [False, True])
def test_nvu_layernorm_grad_same_bits(dev, rows, n, dtype, rms_only):
    """dgamma and dbeta are summed over the rows in a fixed order: two
    launches give the same bits (each instance)."""
    x = _norm_rows(dev, rows, n, dtype)
    dy = torch.randn(rows, n, generator=_gen(dev, 12), device=dev).to(dtype)
    gamma = 1 + 0.1 * torch.randn(n, generator=_gen(dev, 13), device=dev)
    first = ln.nvu_layernorm_grad(x, dy, gamma, 1e-5, 16, rms_only)
    second = ln.nvu_layernorm_grad(x, dy, gamma, 1e-5, 16, rms_only)
    for a, b in zip(first, second):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


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


def _attn_close(got, want):
    g, w = got.float(), want.float()
    gate = ATTN_GRAD_RTOL * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        gate = gate + BF16_RTOL * torch.maximum(w.abs(), g.abs())
    err = (g - w).abs()
    assert bool((err <= gate).all()), float((err - gate).max())


def _attn_operands(dev, b, hq, hkv, sq, skv, d, qdt=torch.bfloat16, qscale=1.0, seed=11,
                   zero_rows=False):
    g = _gen(dev, seed)
    q = (torch.randn(b, sq, hq, d, generator=g, device=dev) * qscale)
    if zero_rows:
        q[:, ::3] = 0
    k = torch.randn(b, skv, hkv, d, generator=g, device=dev)
    v = torch.randn(b, skv, hkv, d, generator=g, device=dev)
    do = torch.randn(b, sq, hq, d, generator=g, device=dev)
    # the models' layout: (B, H, S, D) views of (B, S, H, D) projections
    return (q.to(qdt).permute(0, 2, 1, 3), k.bfloat16().permute(0, 2, 1, 3),
            v.bfloat16().permute(0, 2, 1, 3), do.bfloat16().permute(0, 2, 1, 3))


# the CPU file's cases (its f32 k/v case has no card route: the kernel takes bf16 k, v)
ATTN_CASES = {
    "pwl": dict(), "exact": dict(pwl=False), "f32-q": dict(qdt=torch.float32),
    "f32-q-exact": dict(qdt=torch.float32, pwl=False), "gqa-1-1": dict(hq=4, hkv=4),
    "gqa-8-1": dict(hq=8, hkv=1), "window-below-seq": dict(sq=48, skv=48, window=16),
    "window-exact": dict(sq=48, skv=48, window=16, pwl=False),
    "cross": dict(sq=8, skv=40, causal=False), "cross-exact": dict(sq=8, skv=40, causal=False,
                                                                   pwl=False),
    "softcap-50": dict(cap=50.0, qscale=8.0), "softcap-50-exact": dict(cap=50.0, qscale=8.0,
                                                                       pwl=False),
    "tied-maxima": dict(zero_rows=True), "past-exp-clamp": dict(qscale=30.0),
    "odd-lengths": dict(sq=37, skv=53, window=20),
    # GQA groups 1, 2, 5, 12 and 16 at a decode step (one query over a
    # sequence), a prefill and past 1024 visible keys, with a window and a cap
    "group-1-decode": dict(hq=4, hkv=4, sq=1, skv=200),
    "group-5-decode": dict(hq=10, hkv=2, sq=1, skv=300),
    "group-12-decode": dict(hq=12, hkv=1, sq=1, skv=700),
    "group-16-decode": dict(hq=32, hkv=2, sq=1, skv=256),
    "group-5-prefill": dict(hq=10, hkv=2, sq=40, skv=40),
    "group-12-window": dict(hq=12, hkv=1, sq=160, skv=160, window=64),
    "group-16-cap": dict(hq=16, hkv=1, sq=48, skv=48, cap=50.0, qscale=8.0),
    "past-1024-keys": dict(hq=4, hkv=2, sq=64, skv=1100),
}
# chip_smoke.py's rows: (B, Hq, Hkv, Sq, Skv, D), causal, window, cap
ATTN_MODEL_SHAPES = {
    "starcoder2": ((4, 24, 2, 1024, 1024, 128), True, 4096, 0.0),
    "granite": ((4, 16, 8, 1024, 1024, 64), True, 0, 0.0),
    "glm4": ((1, 32, 2, 1024, 1024, 128), True, 0, 0.0),
    "gemma3-window": ((1, 32, 16, 2048, 2048, 128), True, 1024, 0.0),
    "gemma3-window-cap50": ((1, 32, 16, 2048, 2048, 128), True, 1024, 50.0),
    "whisper-cross": ((8, 8, 8, 448, 1500, 64), False, 0, 0.0),
}


def _attn_check(dev, ops_in, kw):
    """The backward kernel, from the forward kernel's row statistics, within
    `dense_attention_grad_gates` of the plain backward (which recomputes
    its own); a second launch on the same operands gives the same bits."""
    q, k, v, do = ops_in
    _, stats = fa.dense_attention(q, k, v, with_stats=True, **kw)
    got = _counted("flash_attention_grad",
                   lambda: fa.dense_attention_grad(q, k, v, do, stats=stats, **kw))
    again = fa.dense_attention_grad(q, k, v, do, stats=stats, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.dense_attention_grad_plain(q, k, v, do, **kw)
    gates = fa.dense_attention_grad_gates(q, k, v, do, want, **kw)
    for a, b, t, gate in zip(got, want, (q, k, v), gates):
        assert a.dtype == t.dtype and a.shape == t.shape and bool(torch.isfinite(a).all())
        g, w = a.float(), b.float()
        ulp = BF16_RTOL * torch.maximum(w.abs(), g.abs()) if a.dtype == torch.bfloat16 else 0
        assert bool(((g - w).abs() <= gate + ulp).all()), float(((g - w).abs() - ulp).max())


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_dense_attention_grad_cases(dev, name):
    c = dict(dict(b=2, hq=4, hkv=2, sq=24, skv=24, d=32, causal=True, window=0, cap=0.0,
                  pwl=True, qdt=torch.bfloat16, qscale=1.0, zero_rows=False), **ATTN_CASES[name])
    for d in (32, 64, 128):
        ops_in = _attn_operands(dev, c["b"], c["hq"], c["hkv"], c["sq"], c["skv"], d, c["qdt"],
                                c["qscale"], zero_rows=c["zero_rows"])
        _attn_check(dev, ops_in, dict(causal=c["causal"], window=c["window"],
                                      softcap=c["cap"], use_pwl=c["pwl"]))


@pytest.mark.parametrize("name", list(ATTN_MODEL_SHAPES))
@pytest.mark.parametrize("pwl", [True, False])
def test_dense_attention_grad_model_shapes(dev, name, pwl):
    shape, causal, window, cap = ATTN_MODEL_SHAPES[name]
    ops_in = _attn_operands(dev, *shape)
    _attn_check(dev, ops_in, dict(causal=causal, window=window, softcap=cap, use_pwl=pwl))


def test_dense_attention_fn_on_the_card_matches_the_cpu(dev):
    """`ops.dense_attention` with gradients on the card (the forward kernel,
    then `DenseAttentionFn`'s backward kernel) against the same on the CPU."""
    ops_in = _attn_operands(dev, 2, 8, 2, 64, 64, 64, qscale=2.0)

    def run(device):
        q, k, v, do = (t.detach().to(device) for t in ops_in)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.dense_attention(*leaves, window=32, out_dtype=v.dtype)
        out.backward(do)
        return [t.grad.cpu() for t in leaves]

    before = LAUNCHES["flash_attention_grad"]
    got = run(dev)
    assert LAUNCHES["flash_attention_grad"] == before + 1
    for a, b in zip(got, run("cpu")):
        _attn_close(a, b)


def test_dense_attention_grad_refuses_on_the_card(dev):
    q, k, v, do = _attn_operands(dev, 1, 4, 2, 16, 16, 32)
    with pytest.raises(ValueError, match="bf16 k, v, do"):
        fa.dense_attention_grad(q, k.float(), v.float(), do)
    with pytest.raises(ValueError, match="bf16 k, v, do"):
        fa.dense_attention_grad(q, k, v, do.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.dense_attention_grad(q[..., :16], k[..., :16], v[..., :16], do[..., :16])
    with pytest.raises(ValueError, match="row statistics"):
        fa.dense_attention_grad(q, k, v, do)

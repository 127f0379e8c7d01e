"""Each CUDA kernel against its plain PyTorch version on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc: every test is marked `cuda` and skips
without a card.  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Tolerances (atol, rtol): those of tests/test_kernels.py for f32 results, as
the kernels evaluate the PWL in prefix-delta form and the plain versions by
gather, and sums run in another order; a bf16 result may also round to the
neighbouring bf16 value (rtol 2^-7).  The int8 product is exact, whatever
the tiling or the split of K.
"""
import pytest
import torch

from repro_torch.core import nvu
from repro_torch.core.pwl import _FUNCS, get_table
from repro_torch.core.quant import quantize
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nvu_layernorm as ln
from repro_torch.kernels import nvu_softmax as sm
from repro_torch.kernels import pwl_eval as pe
from repro_torch.kernels import quant_matmul as qm

pytestmark = pytest.mark.cuda

BF16_RTOL = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _close(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), float(err.max())


def _launched(name, before):
    assert LAUNCHES[name] == before + 1


@pytest.mark.parametrize("shape", [(7, 1), (33, 130), (1024, 3072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["gelu", "exp"])
def test_pwl_eval(dev, shape, dtype, fn):
    x = (torch.randn(shape, generator=_gen(dev), device=dev) * 4).to(dtype)
    before = LAUNCHES["pwl_eval"]
    got = pe.pwl_eval(x, fn)
    _launched("pwl_eval", before)
    assert got.dtype == dtype and got.device == x.device
    want = pe.pwl_eval_plain(x, get_table(fn, 16))
    _close(got, want, 1e-5, BF16_RTOL if dtype == torch.bfloat16 else 1e-5)


def _bits(t):
    """float32 bits of t, NaN as one pattern."""
    f = t.float()
    return torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f).view(torch.int32)


def _pwl_c(x, y, name):
    """The C entry on x into y, dtypes as given (bf16 in, f32 out, or the
    reverse, which no wrapper asks for)."""
    from repro_torch.kernels.build import check, library, stream_handle
    tab = pe.device_table(name, 16, x.device)
    check(library().npe_pwl_eval(
        x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
        int(y.dtype == torch.bfloat16), tab.data_ptr(), tab.shape[1] - 1, stream_handle(x)),
        "pwl_eval")
    return y


def _pwl_input(dev, n, dtype, offset, name):
    """n values as a contiguous view `offset` elements into its storage (an
    odd offset is not 16-byte aligned), with the table's knots, +-0 and
    +-inf among them."""
    flat = torch.randn(n + offset, generator=_gen(dev, 14), device=dev) * 4
    knots = pe.device_table(name, 16, dev)[0, 1:-1]
    special = torch.cat([knots, torch.tensor([0.0, -0.0, float("inf"), float("-inf")],
                                            device=dev)])
    m = min(n, special.numel())
    flat[offset:offset + m] = special[:m]
    return flat.to(dtype)[offset:]


# lengths: 1 and 7 (not a multiple of 8: the scalar instance), 8, a decode
# step's GELU and an encoder forward's; offset 1 puts any of them in the
# scalar instance
PWL_LENGTHS = [1, 7, 8, 24576, 1024 * 3072]


@pytest.mark.parametrize("n", PWL_LENGTHS)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["gelu", "exp"])
def test_pwl_eval_is_the_walk_bit_for_bit(dev, n, offset, dtype, fn):
    """Both instances: f32 results equal the prefix-delta walk in torch f32
    ops bit for bit, bf16 results that value rounded to nearest even."""
    x = _pwl_input(dev, n, dtype, offset, fn).view(1, n)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = LAUNCHES["pwl_eval"]
    got = pe.pwl_eval(x, fn)
    _launched("pwl_eval", before)
    want = pe.pwl_eval_walk(x, pe.device_table(fn, 16, dev)).to(dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", sorted(_FUNCS))
def test_pwl_eval_every_table_is_the_walk(dev, dtype, fn):
    """Every table of the reference's `_FUNCS` (GLM4-9B's SiLU among them)
    through the prefix search, at (8, 13696): the walk's bits."""
    if fn in ("recip", "rsqrt", "sqrt"):
        x = 0.25 + 0.75 * torch.rand(8, 13696, generator=_gen(dev), device=dev)
    else:
        x = torch.randn(8, 13696, generator=_gen(dev), device=dev) * 8
    x = x.to(dtype)
    got = pe.pwl_eval(x, fn)
    want = pe.pwl_eval_walk(x, pe.device_table(fn, 16, dev)).to(dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [7, 24576])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["gelu", "exp"])
def test_pwl_eval_wide_table_is_the_walk(dev, n, dtype, fn):
    """32 segments (34 with the guards): twice the prefix rows' in-order
    adds and one more search step; still the walk's bits."""
    x = _pwl_input(dev, n, dtype, 0, fn).view(1, n)
    got = pe.pwl_eval(x, fn, segments=32)
    want = pe.pwl_eval_walk(x, pe.device_table(fn, 32, dev)).to(dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", PWL_LENGTHS)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("x_dtype,y_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_pwl_eval_mixed_dtypes_is_the_walk(dev, n, offset, x_dtype, y_dtype):
    x = _pwl_input(dev, n, x_dtype, offset, "gelu")
    y = torch.empty(n + offset, dtype=y_dtype, device=dev)[offset:]
    got = _pwl_c(x, y, "gelu")
    torch.cuda.synchronize()
    want = pe.pwl_eval_walk(x, pe.device_table("gelu", 16, dev)).to(y_dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,k,n", [(8, 128, 64), (100, 300, 70), (17, 5, 3),
                                   (1024, 768, 768), (1024, 3072, 768),
                                   (1024, 768, 30720)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_exact(dev, m, k, n, out_dtype):
    g = _gen(dev, 1)
    xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
    wq = quantize(torch.randn(k, n, generator=g, device=dev), 8, axis=1)
    before = LAUNCHES["quant_matmul"]
    got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, out_dtype=out_dtype)
    _launched("quant_matmul", before)
    want = qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale, out_dtype=out_dtype)
    assert torch.equal(got, want)


# the four projections of a decode step at 1, 8, 16 and 17 rows (M <= 16 runs
# the split-K kernel, 17 the tiled one), then K not a multiple of 32 (48: a
# partial k-tile; 100, 300, 1000: not a multiple of 16 either, staged by
# byte loads), N ragged; every split of K must give the same bits
ROW_SHAPES = [(m, k, n) for m in (1, 8, 16, 17)
              for k, n in ((768, 768), (768, 3072), (3072, 768), (768, 30720))] + [
    (1, 100, 200), (16, 300, 70), (17, 200, 48), (8, 48, 768), (16, 1000, 768),
    (3, 3072, 40), (16, 4096, 16)]


@pytest.mark.parametrize("m,k,n", ROW_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_rows_exact(dev, m, k, n, out_dtype):
    g = _gen(dev, 11)
    xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
    wq = quantize(torch.randn(k, n, generator=g, device=dev), 8, axis=1)
    before = LAUNCHES["quant_matmul"]
    got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, out_dtype=out_dtype)
    _launched("quant_matmul", before)
    want = qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale, out_dtype=out_dtype)
    assert torch.equal(got, want)


def test_quant_matmul_rows_workspace_left_zeroed(dev):
    """Split-K launches share one workspace on a stream; each leaves it zeroed,
    so repeated and interleaved shapes stay exact."""
    g = _gen(dev, 13)
    ops_ = []
    for m, k, n in ((8, 3072, 768), (1, 768, 768), (8, 3072, 768), (16, 768, 3072)):
        xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
        wq = quantize(torch.randn(k, n, generator=g, device=dev), 8, axis=1)
        ops_.append((xq, wq))
    for _ in range(3):
        for xq, wq in ops_:
            got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale)
            assert torch.equal(got, qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale))


def test_quant_matmul_rows_fused_gelu_exact(dev):
    """The fused PWL epilogue after a split-K sum, (8, 3072) @ (3072, 768)."""
    g = _gen(dev, 12)
    xq = quantize(torch.randn(8, 3072, generator=g, device=dev), 8)
    wq = quantize(torch.randn(3072, 768, generator=g, device=dev) / 55, 8, axis=1)
    got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, "gelu")
    want = qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale, get_table("gelu", 16))
    _close(got, want, 1e-5, 1e-5)


def test_quant_matmul_extremes_exact(dev):
    """All -128 operands at K=3072: sums of 5e7, beyond float32's 2^24."""
    a = torch.full((64, 3072), -128, dtype=torch.int8, device=dev)
    b = torch.full((3072, 64), -128, dtype=torch.int8, device=dev)
    one = torch.ones(1, device=dev)
    got = qm.quant_matmul(a, b, one, torch.ones(64, device=dev))
    assert bool((got == 128 * 128 * 3072).all())


def test_quant_matmul_fused_gelu(dev):
    g = _gen(dev, 2)
    xq = quantize(torch.randn(64, 256, generator=g, device=dev), 8)
    wq = quantize(torch.randn(256, 128, generator=g, device=dev) / 16, 8, axis=1)
    got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, "gelu")
    want = qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale, get_table("gelu", 16))
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("rows,cols,causal", [(8, 128, 0), (100, 512, 0), (256, 1000, 0),
                                              (128, 128, 128), (12288, 128, 0),
                                              (12288, 128, 128), (96, 40, 16)])
def test_nvu_softmax(dev, rows, cols, causal):
    x = torch.randn(rows, cols, generator=_gen(dev, 3), device=dev) * 3
    before = LAUNCHES["nvu_softmax"]
    got = sm.nvu_softmax(x, causal_rows=causal)
    _launched("nvu_softmax", before)
    _close(got, sm.nvu_softmax_plain(x, causal_rows=causal), 2e-5, 2e-5)


SOFTMAX_SHAPES = [(8, 128, 0), (100, 512, 0), (256, 1000, 0), (12288, 128, 0),
                  (12288, 128, 128), (96, 40, 16), (7, 32, 0), (33, 64, 0), (50, 256, 0)]


@pytest.mark.parametrize("rows,cols,causal", SOFTMAX_SHAPES)
@pytest.mark.parametrize("scale", [1.0, 0.125, 32 ** -0.5])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_nvu_softmax_is_the_walk_bit_for_bit(dev, rows, cols, causal, scale, out_dtype):
    """Every instance (1-32 values a lane, 1-8 rows a warp), with the scale
    and both outputs: the bits of `nvu_softmax_walk`, the kernel's arithmetic
    and order of addition in torch ops (the first port's kernel's order, so
    the f32 results are its bits too); within the plain version's gate."""
    x = torch.randn(rows, cols, generator=_gen(dev, 18), device=dev) * 20
    before = LAUNCHES["nvu_softmax"]
    got = sm.nvu_softmax(x, causal_rows=causal, scale=scale, out_dtype=out_dtype)
    _launched("nvu_softmax", before)
    assert got.dtype == out_dtype and got.shape == x.shape
    want = sm.nvu_softmax_walk(x, causal_rows=causal, scale=scale, out_dtype=out_dtype)
    assert torch.equal(_bits(got), _bits(want))
    plain = sm.nvu_softmax_plain(x, causal_rows=causal, scale=scale, out_dtype=out_dtype)
    _close(got, plain, 2e-5, BF16_RTOL if out_dtype == torch.bfloat16 else 2e-5)


def test_nvu_softmax_scale_and_cast_fold_bit_for_bit(dev):
    """The encoder's call (scale 0.125, bf16 out) gives the bits of the two
    torch ops it replaces around an f32 call: x * 0.125, then .to(bf16)."""
    x = torch.randn(12288, 128, generator=_gen(dev, 19), device=dev) * 3
    got = sm.nvu_softmax(x, scale=0.125, out_dtype=torch.bfloat16)
    assert torch.equal(got, sm.nvu_softmax(x * 0.125).to(torch.bfloat16))


GRAD_RTOL = 2e-5   # chip_smoke.py's backward gate: of the plain result's largest value


@pytest.mark.parametrize("n", [32, 128, 1024])
@pytest.mark.parametrize("mask", ["none", "causal", "limit"])
@pytest.mark.parametrize("dy_dtype", [torch.float32, torch.bfloat16])
def test_nvu_softmax_grad_instances(dev, n, mask, dy_dtype):
    """The softmax backward's instances (one column a lane at n = 32, four
    at 128, 32 at 1024) with tied maxima, a whole row tied, causal and limit
    masks (a row with no visible column), dy f32 and bf16: within
    GRAD_RTOL of the largest value of `nvu_softmax_grad_plain`, and the same
    bits from a second launch."""
    rows = 4096 if n == 32 else 600
    g = _gen(dev, 29)
    x = torch.randn(rows, n, generator=g, device=dev) * 3
    x[0, 3] = x[0, 7] = x[0].max() + 1
    x[1] = 2.5
    dy = torch.randn(rows, n, generator=g, device=dev).to(dy_dtype)
    kw = dict(scale=0.125)
    if mask == "causal":
        kw["causal_rows"] = n
    elif mask == "limit":
        limit = torch.randint(0, n + 1, (rows,), generator=g, device=dev, dtype=torch.int32)
        limit[5] = 0
        kw["limit"] = limit
    before = LAUNCHES["nvu_softmax_grad"]
    got = sm.nvu_softmax_grad(x, dy, **kw)
    _launched("nvu_softmax_grad", before)
    assert torch.equal(sm.nvu_softmax_grad(x, dy, **kw), got)
    want = sm.nvu_softmax_grad_plain(x, dy, **kw)
    err = (got - want).abs()
    assert bool((err <= GRAD_RTOL * float(want.abs().max())).all()), float(err.max())


@pytest.mark.parametrize("rows,cols,rms", [(16, 768, False), (100, 512, False),
                                           (64, 1024, True), (3, 256, True),
                                           (1024, 768, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nvu_layernorm(dev, rows, cols, rms, dtype):
    g = _gen(dev, 4)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 3 + 0.7).to(dtype)
    gam = 1 + 0.1 * torch.randn(cols, generator=g, device=dev)
    bet = None if rms else 0.1 * torch.randn(cols, generator=g, device=dev)
    eps = 1e-6 if rms else 1e-12
    before = LAUNCHES["nvu_layernorm"]
    got = ln.nvu_layernorm(x, gam, bet, eps=eps, rms_only=rms)
    _launched("nvu_layernorm", before)
    want = ln.nvu_layernorm_plain(x, gam, bet, eps=eps, rms_only=rms)
    _close(got, want, 3e-5, BF16_RTOL if dtype == torch.bfloat16 else 3e-5)


def _ln_case(dev, rows, cols, dtype, offset=0, seed=15):
    g = _gen(dev, seed)
    flat = torch.randn(rows * cols + offset, generator=g, device=dev) * 3 + 0.7
    x = flat.to(dtype)[offset:].view(rows, cols)
    gam = 1 + 0.1 * torch.randn(cols, generator=g, device=dev)
    bet = 0.1 * torch.randn(cols, generator=g, device=dev)
    return x, gam, bet


# warp instance: 768 (BERT), 1024, 2048 columns; block instance: 2056 and
# wider, and a row that is not 16-byte aligned (offset 1)
LN_COLS = [(768, 0), (1024, 0), (2048, 0), (2056, 0), (4096, 0), (8192, 0), (768, 1)]


@pytest.mark.parametrize("cols,offset", LN_COLS)
@pytest.mark.parametrize("rows", [1, 8, 1024, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nvu_layernorm_instances(dev, rows, cols, offset, dtype):
    x, gam, bet = _ln_case(dev, rows, cols, dtype, offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = LAUNCHES["nvu_layernorm"]
    got = ln.nvu_layernorm(x, gam, bet, eps=1e-12)
    _launched("nvu_layernorm", before)
    want = ln.nvu_layernorm_plain(x, gam, bet, eps=1e-12)
    _close(got, want, 3e-5, BF16_RTOL if dtype == torch.bfloat16 else 3e-5)


@pytest.mark.parametrize("cols,offset", LN_COLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["rms_only", "no_beta", "segments_32"])
def test_nvu_layernorm_instances_options(dev, cols, offset, dtype, variant):
    """rms_only, beta=None, and a 35-column rsqrt table (the block instance
    at any width) on both instances, 8 rows."""
    x, gam, bet = _ln_case(dev, 8, cols, dtype, offset, seed=16)
    kw = dict(eps=1e-6 if variant == "rms_only" else 1e-12,
              rms_only=variant == "rms_only",
              segments=32 if variant == "segments_32" else 16)
    b = None if variant == "no_beta" else bet
    got = ln.nvu_layernorm(x, gam, b, **kw)
    want = ln.nvu_layernorm_plain(x, gam, b, **kw)
    _close(got, want, 3e-5, BF16_RTOL if dtype == torch.bfloat16 else 3e-5)


@pytest.mark.parametrize("cols", [256, 264, 768, 1024, 2048])
@pytest.mark.parametrize("rows", [8, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["layernorm", "rms_only", "no_beta"])
def test_nvu_layernorm_warp_is_the_block_bit_for_bit(dev, rows, cols, dtype, variant):
    """The warp instance adds in the block instance's order: the same values,
    aligned (warp) and one element into their storage (block), give the same
    bits."""
    x, gam, bet = _ln_case(dev, rows, cols, dtype, seed=17)
    skew = torch.empty(rows * cols + 1, dtype=dtype, device=dev)[1:].view(rows, cols)
    skew.copy_(x)
    kw = dict(eps=1e-6 if variant == "rms_only" else 1e-12, rms_only=variant == "rms_only")
    b = None if variant == "no_beta" else bet
    warp = ln.nvu_layernorm(x, gam, b, **kw)
    block = ln.nvu_layernorm(skew, gam, b, **kw)
    assert torch.equal(warp.float().view(torch.int32), block.float().view(torch.int32))


def test_layernorm_rsqrt_over_the_f32_range(dev):
    """The layernorm kernel's integer frexp/ldexp on variances from about
    1e-18 to 1e18 (rows scaled by 1e-9 .. 1e9), odd and even exponents."""
    for scale in (1e-9, 1e-3, 1.0, 1e3, 1e9):
        x = torch.randn(8, 256, generator=_gen(dev, 5), device=dev) * scale
        ones = torch.ones(256, device=dev)
        got = ln.nvu_layernorm(x, ones, None, eps=0.0)
        want = ln.nvu_layernorm_plain(x, ones, None, eps=0.0)
        _close(got, want, 3e-5, 3e-5)


def test_ops_on_the_card_match_the_cpu_route(dev):
    """The wrappers' CUDA route against their CPU route on the same values."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 16, 64, generator=g)
    w = torch.randn(64, 48, generator=g) / 8
    gam, bet = torch.ones(64), torch.zeros(64)
    for f, atol in [(lambda t: ops.pwl_activation(t, "gelu"), 1e-5),
                    (lambda t: ops.softmax(t), 2e-5),
                    (lambda t: ops.softmax(t, causal=True), 2e-5),
                    (lambda t: ops.layernorm(t, gam.to(t.device), bet.to(t.device),
                                             eps=1e-12), 3e-5)]:
        _close(f(x.to(dev)).cpu(), f(x), atol, atol)
    q_card, q_cpu = ops.quant_dense(x.to(dev), w.to(dev)).cpu(), ops.quant_dense(x, w)
    _close(q_card, q_cpu, 1e-5, 1e-5)


# (b, hq, hkv, sq, skv, d, kv_len, causal, window, block_q, block_kv)
FLASH_CASES = [
    (8, 12, 12, 1, 256, 64, 192, True, 0, 256, 256),      # BERT-base decode step
    (1, 12, 12, 128, 256, 64, 128, True, 0, 128, 256),    # one-slot prefill
    (2, 12, 12, 64, 512, 64, 512, True, 0, 64, 256),      # several KV blocks
    (2, 8, 2, 64, 256, 64, 200, True, 48, 32, 64),        # GQA, window, ragged kv_len
    (2, 4, 2, 37, 96, 32, 77, False, 0, 16, 32),          # D=32, no mask
    (1, 4, 4, 20, 1024, 128, 1000, True, 0, 8, 1024),     # D=128, largest block
    (8, 12, 12, 1, 256, 64, 192, True, 0, 256, 64),       # decode over three KV blocks
    (2, 12, 12, 37, 256, 64, 93, True, 0, 256, 256),      # Sq, kv_len not multiples of 16
    (4, 8, 2, 1, 256, 64, 200, True, 48, 256, 64),        # GQA decode with a window
    (2, 4, 4, 3, 128, 32, 70, True, 0, 256, 32),          # 3 query rows, decode instance
]


def _flash_inputs(dev, b, hq, hkv, sq, skv, d, q_dtype, kv_dtype, seed=7):
    """q as a permuted view of (B, Sq, Hq, D) and k, v of a (B, Skv, Hkv, D)
    cache, as the decode path hands them over."""
    g = _gen(dev, seed)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(q_dtype).permute(0, 2, 1, 3)
    k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(kv_dtype).permute(0, 2, 1, 3)
    v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(kv_dtype).permute(0, 2, 1, 3)
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
@pytest.mark.parametrize("q_dtype,kv_dtype,out_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16)])
def test_flash_attention(dev, case, use_pwl, q_dtype, kv_dtype, out_dtype):
    b, hq, hkv, sq, skv, d, kv_len, causal, window, bq, bkv = case
    q, k, v = _flash_inputs(dev, b, hq, hkv, sq, skv, d, q_dtype, kv_dtype)
    kw = dict(causal=causal, window=window, use_pwl=use_pwl, block_q=bq,
              block_kv=bkv, kv_len=kv_len, out_dtype=out_dtype)
    before = LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    _launched("flash_attention", before)
    assert got.shape == (b, hq, sq, d) and got.dtype == out_dtype
    want = fa.flash_attention_plain(q, k, v, **kw)
    _close(got, want, 2e-5, BF16_RTOL if out_dtype == torch.bfloat16 else 2e-5)


def test_flash_attention_never_reads_past_kv_len(dev):
    q, k, v = _flash_inputs(dev, 2, 4, 4, 3, 128, 64, torch.float32, torch.bfloat16)
    k[:, :, 70:], v[:, :, 70:] = float("nan"), float("nan")
    got = fa.flash_attention(q, k, v, kv_len=70, block_kv=32)
    assert bool(torch.isfinite(got).all())
    want = fa.flash_attention_plain(q, k[:, :, :70], v[:, :, :70], block_kv=32)
    _close(got, want, 2e-5, 2e-5)


def test_flash_attention_kv_rows_not_vectors(dev):
    """bf16 K/V whose rows are not contiguous 16-byte vectors (D strided)
    are staged into rows first; the result is the plain version's."""
    g = _gen(dev, 9)
    q = torch.randn(2, 4, 24, 64, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 2, 64, 96, generator=g, device=dev).to(torch.bfloat16).transpose(-1, -2)
    v = torch.randn(2, 2, 64, 96, generator=g, device=dev).to(torch.bfloat16).transpose(-1, -2)
    assert k.stride(3) != 1
    for sq in (1, 24):
        kw = dict(kv_len=90, block_kv=32, out_dtype=torch.float32)
        got = fa.flash_attention(q[:, :, :sq], k, v, **kw)
        _close(got, fa.flash_attention_plain(q[:, :, :sq], k, v, **kw), 2e-5, 2e-5)


def test_flash_ops_on_the_card_match_the_cpu_route(dev):
    g = torch.Generator().manual_seed(8)
    q = torch.randn(2, 4, 5, 64, generator=g)
    k, v = torch.randn(2, 2, 40, 64, generator=g), torch.randn(2, 2, 40, 64, generator=g)
    for kw in (dict(), dict(use_pwl=False), dict(kv_len=33, block_kv=16)):
        got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw).cpu()
        _close(got, ops.flash_attention(q, k, v, **kw), 2e-5, 2e-5)


# the dense mode: (b, hq, hkv, sq, skv, d, kv_len); rows a kv head <= 8 run
# the decode instance, more the tensor-core one; a pass holds 8192 keys of
# one row, 1024 of 2-8 rows or of a 16-row tile: past that, several passes
DENSE_CASES = [
    (8, 12, 12, 1, 256, 64, 192),       # BERT-base decode step
    (8, 12, 12, 1, 1024, 64, 1024),     # one pass
    (8, 12, 12, 1, 2048, 64, 2048),     # one pass
    (2, 12, 12, 1, 9000, 32, 8193),     # two segments of one row, the second of one key
    (2, 12, 12, 1, 32768, 64, 32768),   # the longest cache Server accepts: four segments
    (2, 8, 2, 1, 3000, 64, 2999),       # GQA 4 rows a kv head, three segments
    (2, 4, 4, 5, 128, 32, 77),          # a 5-token prefill, decode instance
    (1, 12, 12, 128, 256, 64, 128),     # 128-token prefill, tensor cores
    (1, 12, 12, 300, 320, 64, 300),     # prefill crossing 256
    (1, 4, 2, 37, 2100, 128, 2100),     # 37 rows over three segments, D=128
    (2, 4, 2, 20, 96, 32, 90),          # D=32, ragged
    (8, 32, 2, 1, 256, 128, 256),       # GLM4-9B decode step: 16 rows a kv head, D=128
    (1, 32, 2, 128, 256, 128, 128),     # GLM4-9B 128-token prefill
    # the tensor-core instances by GQA group (rows a kv head: <= 8 decode
    # instance, 9-16 and 17-32 the transposed one, more the row-major one)
    (2, 10, 2, 1, 300, 64, 300),        # group 5, a decode step: 5 rows
    (2, 10, 2, 3, 300, 64, 300),        # group 5, 3 queries: 15 rows, transposed
    (2, 24, 2, 1, 1500, 128, 1500),     # group 12 over 1500 keys: 12 rows, transposed
    (2, 24, 1, 1, 700, 32, 700),        # group 24, D=32: 24 rows, transposed
    (2, 32, 2, 2, 600, 64, 600),        # group 16, 2 queries: 32 rows, transposed
    (1, 10, 2, 40, 1200, 64, 1200),     # group 5, 40 queries: 200 rows, row-major
    (2, 24, 2, 160, 160, 128, 160),     # group 12 at a training-like prefill
    (1, 32, 2, 64, 1100, 128, 1100),    # group 16 past 1024 visible keys
]


def _dense_close(q, k, v, kw, got):
    """Within one bf16 ulp (or 2e-5 for an f32 output) of the plain version,
    plus 2^-7 of sum p|v|: sums run in another order and the PWL is the
    prefix table against the gather, so a probability can round to the
    neighbouring bf16 value before P.V."""
    want = fa.dense_attention_plain(q, k, v, **kw)
    spread = fa.dense_attention_plain(q, k, v.abs(), **dict(kw, out_dtype=torch.float32))
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else 2e-5
    err = (got.float() - want.float()).abs()
    bound = 2e-5 + rtol * want.float().abs() + 2.0 ** -7 * spread
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
@pytest.mark.parametrize("q_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.bfloat16),
                                               (torch.float32, torch.float32)])
def test_dense_attention(dev, case, use_pwl, q_dtype, out_dtype):
    b, hq, hkv, sq, skv, d, kv_len = case
    q, k, v = _flash_inputs(dev, b, hq, hkv, sq, skv, d, q_dtype, torch.bfloat16, seed=20)
    kw = dict(kv_len=kv_len, use_pwl=use_pwl, out_dtype=out_dtype)
    before = LAUNCHES["flash_attention"]
    got = fa.dense_attention(q, k, v, **kw)
    _launched("flash_attention", before)
    assert got.shape == (b, hq, sq, d) and got.dtype == out_dtype
    _dense_close(q, k, v, kw, got)


@pytest.mark.parametrize("sq,kv_len", [(1, 70), (3, 70), (24, 90), (1, 1500), (3, 1500),
                                       (24, 1500), (1, 9000)])
def test_dense_attention_never_reads_past_kv_len(dev, sq, kv_len):
    q, k, v = _flash_inputs(dev, 2, 4, 2, sq, 9100, 64, torch.bfloat16, torch.bfloat16, seed=21)
    k[:, :, kv_len:], v[:, :, kv_len:] = float("nan"), float("nan")
    got = fa.dense_attention(q, k, v, kv_len=kv_len)
    assert bool(torch.isfinite(got.float()).all())
    _dense_close(q, k[:, :, :kv_len], v[:, :, :kv_len], dict(kv_len=kv_len), got)


def test_dense_attention_ops_on_the_card_match_the_cpu_route(dev):
    g = torch.Generator().manual_seed(22)
    q = torch.randn(2, 4, 5, 64, generator=g)
    k = torch.randn(2, 2, 40, 64, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 2, 40, 64, generator=g).to(torch.bfloat16)
    for kw in (dict(), dict(use_pwl=False), dict(kv_len=33)):
        kw["out_dtype"] = torch.float32
        got = ops.dense_attention(q.to(dev), k.to(dev), v.to(dev), **kw).cpu()
        _dense_close(q, k, v, kw, got)


# the dense mode's window, causal switch and soft cap: (b, hq, hkv, sq, skv, d,
# kv_len, causal, window, softcap)
DENSE_MASK_CASES = [
    (2, 32, 16, 1, 1024, 128, 1024, False, 0, 0.0),    # gemma3 ring, every key valid
    (2, 32, 16, 1, 1024, 128, 300, False, 0, 0.0),     # the same ring before the wrap
    (1, 32, 16, 300, 300, 128, 300, True, 64, 0.0),    # windowed prefill, tensor cores
    (1, 4, 2, 2048, 2048, 64, 2048, True, 1024, 0.0),  # windowed prefill, two segments a tile
    (2, 4, 2, 3, 2000, 64, 2000, True, 100, 0.0),      # windowed decode instance, 3 queries
    (2, 24, 2, 1, 4096, 128, 4096, False, 0, 0.0),     # starcoder2 12:1 ring, tensor cores
    (2, 4, 2, 1, 9000, 64, 9000, False, 0, 0.0),       # a ring past one 8192-key segment
    (2, 32, 16, 1, 512, 128, 512, True, 0, 50.0),      # soft-capped decode
    (1, 4, 2, 64, 64, 64, 64, True, 0, 5.0),           # soft-capped prefill, tight cap
    (1, 4, 2, 64, 64, 64, 64, True, 16, 5.0),          # windowed and soft-capped
]


@pytest.mark.parametrize("case", DENSE_MASK_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
def test_dense_attention_window_ring_softcap(dev, case, use_pwl):
    b, hq, hkv, sq, skv, d, kv_len, causal, window, softcap = case
    q, k, v = _flash_inputs(dev, b, hq, hkv, sq, skv, d, torch.bfloat16, torch.bfloat16,
                            seed=23)
    q = q * 4                           # scores past the soft caps' knees
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap,
              use_pwl=use_pwl, out_dtype=torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    got = fa.dense_attention(q, k, v, **kw)
    _launched("flash_attention", before)
    assert got.shape == (b, hq, sq, d)
    _dense_close(q, k, v, kw, got)


@pytest.mark.parametrize("sq,kv_len,window", [(1, 700, 64), (3, 700, 64), (40, 700, 64),
                                              (1, 9000, 100), (40, 2100, 1024)])
def test_dense_attention_never_reads_outside_the_window(dev, sq, kv_len, window):
    """Keys below every row's window are not read: NaN there changes nothing."""
    q, k, v = _flash_inputs(dev, 2, 4, 2, sq, kv_len, 64, torch.bfloat16, torch.bfloat16,
                            seed=24)
    kw = dict(kv_len=kv_len, window=window)
    want = fa.dense_attention(q, k, v, **kw)
    lo = kv_len - sq - window + 1
    k[:, :, :lo], v[:, :, :lo] = float("nan"), float("nan")
    assert torch.equal(fa.dense_attention(q, k, v, **kw), want)


@pytest.mark.parametrize("case", [(2, 12, 12, 40, 300, 64), (2, 24, 2, 1, 1500, 128),
                                  (2, 8, 2, 1, 400, 64), (1, 32, 2, 64, 1100, 128)])
@pytest.mark.parametrize("use_pwl", [True, False])
def test_dense_attention_stats_and_repeat_bits(dev, case, use_pwl):
    """The row statistics the forward writes when asked (as the train step
    asks) are within 1e-4 of the plain version's `row_stats` (the PWL norm
    also within the NVU reciprocal's jump at a power of two, where the two
    sums, added in other orders, may straddle one); the output with them is
    the output without them (a call with <= 8 rows a kv head then takes the
    tensor-core instance: within the dense gate), and two launches on the
    same operands give the same bits."""
    b, hq, hkv, sq, skv, d = case
    q, k, v = _flash_inputs(dev, b, hq, hkv, sq, skv, d, torch.bfloat16, torch.bfloat16, seed=26)
    kw = dict(use_pwl=use_pwl, out_dtype=torch.bfloat16)
    out, stats = fa.dense_attention(q, k, v, with_stats=True, **kw)
    again, stats2 = fa.dense_attention(q, k, v, with_stats=True, **kw)
    assert torch.equal(out, again) and torch.equal(stats, stats2)
    if (hq // hkv) * sq > 8:
        assert torch.equal(out, fa.dense_attention(q, k, v, **kw))
    _dense_close(q, k, v, kw, out)
    _, want = fa.dense_attention_plain(q, k, v, with_stats=True, **kw)
    assert stats.shape == (b, hq, sq, 2)
    one = torch.tensor([1.0])
    jump = float((nvu.nvu_reciprocal(torch.nextafter(one, torch.tensor([0.0])))
                  - nvu.nvu_reciprocal(one)).abs() / nvu.nvu_reciprocal(one)) if use_pwl else 0.0
    gate = torch.stack([1e-4 * want[..., 0].abs().clamp(min=1.0),
                        (1e-4 + jump) * want[..., 1].abs()], -1).to(stats.device)
    assert bool(((stats - want.to(stats.device)).abs() <= gate).all())


@pytest.mark.parametrize("hq,hkv,sq,skv,instance", [
    (8, 8, 1, 300, "flash_dense_split_kernel<64, 1>"),
    (8, 4, 1, 300, "flash_dense_split_kernel<64, 2>"),
    (8, 2, 1, 300, "flash_dense_split_kernel<64, 4>"),
    (10, 2, 1, 300, "flash_dense_split_kernel<64, 8>"),    # 5 rows
    (8, 1, 1, 300, "flash_dense_split_kernel<64, 8>"),
    (12, 1, 1, 300, "flash_dense_wgt_kernel<"), (16, 2, 4, 300, "flash_dense_wgt_kernel<"),
    (8, 2, 40, 300, "flash_dense_wgt_kernel<"), (8, 2, 1100, 1100, "flash_dense_wg_kernel<")])
def test_dense_attention_instance_by_rows(dev, hq, hkv, sq, skv, instance):
    """A call with 8 or fewer rows a kv head (a GQA group's heads times its
    queries) launches the decode instance for its rows rounded up to 1, 2,
    4 or 8; 9 to 32, or more whose 64-row tiles would not fill two waves of
    the SMs, the transposed tensor-core one; more the row-major one.  Each
    call is one `flash_dense` kernel."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _flash_inputs(dev, 2, hq, hkv, sq, skv, 64, torch.bfloat16, torch.bfloat16, seed=27)
    fa.dense_attention(q, k, v)
    for _ in range(3):        # a trace may lose its events: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fa.dense_attention(q, k, v)
            torch.cuda.synchronize()
        names = [(e.key, e.count) for e in prof.key_averages() if "flash_dense" in e.key]
        if names:
            break
    assert len(names) == 1 and names[0][1] == 1 and instance in names[0][0], names


# the decode instance's split across a cluster (fa.dense_decode_split):
# (b, hq, hkv, sq, skv, d, kv_len, causal, window)
SPLIT_CASES = [
    (8, 12, 12, 1, 16384, 64, 16384, True, 0),    # BERT's longest row: 8 blocks a head
    (1, 12, 12, 1, 16384, 64, 16384, True, 0),    # 8 blocks a head, one wave
    (1, 8, 1, 1, 16384, 64, 16384, True, 0),      # 8 rows over 2048 keys a block: two segments
    (8, 8, 8, 1, 1500, 64, 1500, False, 0),       # Whisper's cross step
    (8, 16, 8, 1, 1024, 64, 1000, True, 0),       # Granite's 2:1 group, kv_len past a chunk
    (4, 32, 16, 1, 1024, 128, 700, False, 0),     # a ring's invalid rows at and past kv_len
    (2, 4, 2, 1, 3000, 64, 2999, True, 700),      # a window that starts inside a block's keys
    (2, 8, 2, 1, 3000, 64, 2999, True, 0),        # 4 rows
    (2, 10, 2, 1, 3000, 32, 2999, True, 0),       # 5 rows (the 8-row instance), D = 32
    (2, 4, 2, 2, 3000, 128, 2999, True, 0),       # two queries of a 2:1 group: 4 rows
    (2, 2, 1, 1, 3000, 128, 2999, True, 0),       # 2 rows, D = 128
    (8, 25, 5, 1, 32, 64, 32, False, 0),          # Hymba's 5:1 ring step: one block
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_dense_attention_split(dev, case, use_pwl, q_dtype):
    """The decode instance over a cache split across a cluster's blocks:
    held to the plain version by the dense gate, the same bits from a
    second launch, and the same bits with NaN in every cache row that no
    row sees (past kv_len, below the first row's window), which it never
    reads."""
    b, hq, hkv, sq, skv, d, kv_len, causal, window = case
    assert fa.dense_decode_split(b, hq, hkv, sq, kv_len, window) is not None
    q, k, v = _flash_inputs(dev, b, hq, hkv, sq, skv, d, q_dtype, torch.bfloat16, seed=28)
    kw = dict(kv_len=kv_len, causal=causal, window=window, use_pwl=use_pwl,
              out_dtype=torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    got = fa.dense_attention(q, k, v, **kw)
    _launched("flash_attention", before)
    assert torch.equal(fa.dense_attention(q, k, v, **kw), got)
    _dense_close(q, k, v, kw, got)
    lo = max(0, kv_len - sq - window + 1) if window > 0 else 0
    k2, v2 = k.clone(), v.clone()
    for t in (k2, v2):
        t[:, :, kv_len:] = float("nan")
        t[:, :, :lo] = float("nan")
    assert torch.equal(fa.dense_attention(q, k2, v2, **kw), got)


def test_dense_attention_default_arguments_keep_their_bits(dev):
    """causal=True, window=0, softcap=0 spelled out is the call without them."""
    for sq, kv_len in ((1, 700), (24, 1500)):
        q, k, v = _flash_inputs(dev, 2, 4, 2, sq, 1500, 64, torch.bfloat16, torch.bfloat16,
                                seed=25)
        want = fa.dense_attention(q, k, v, kv_len=kv_len)
        got = fa.dense_attention(q, k, v, kv_len=kv_len, causal=True, window=0, softcap=0.0)
        assert torch.equal(got, want)


# --- per-row MMU scales and the softmax key limit (the npec executor's) ---

@pytest.mark.parametrize("m,k,n", [(1, 768, 64), (8, 768, 768), (8, 768, 64), (16, 3072, 768),
                                   (17, 768, 64), (1024, 768, 64), (1024, 768, 768),
                                   (8, 768, 30720), (5, 100, 30)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_row_scales_exact(dev, m, k, n, out_dtype):
    """(M, 1) activation scales in both kernels (split-K decode rows,
    tiles), the unaligned route and the executor's 64-column head slices:
    the plain version's bits; with every row's scale equal, the bits of the
    per-tensor call."""
    g = _gen(dev, 21)
    x = torch.randn(m, k, generator=g, device=dev) * (1 + torch.rand(m, 1, generator=g, device=dev))
    xq = quantize(x, 8, axis=0)
    wq = quantize(torch.randn(k, n, generator=g, device=dev), 8, axis=1)
    before = LAUNCHES["quant_matmul"]
    got = qm.quant_matmul(xq.q, wq.q, xq.scale, wq.scale, out_dtype=out_dtype)
    _launched("quant_matmul", before)
    assert torch.equal(got, qm.quant_matmul_plain(xq.q, wq.q, xq.scale, wq.scale,
                                                  out_dtype=out_dtype))
    one = xq.scale.reshape(-1)[:1]
    same = qm.quant_matmul(xq.q, wq.q, one.expand(m, 1).contiguous(), wq.scale,
                           out_dtype=out_dtype)
    assert torch.equal(same, qm.quant_matmul(xq.q, wq.q, one, wq.scale, out_dtype=out_dtype))


def test_quant_dense_row_scales_on_the_card(dev):
    """ops.quant_dense(act_axis=0) on the card against the CPU route, bit for
    bit, at the executor's tied logits head ((768, 30720) after the transpose)."""
    g = _gen(dev, 22)
    x = torch.randn(8, 768, generator=g, device=dev)
    table = torch.randn(30720, 768, generator=g, device=dev) * 0.02
    got = ops.quant_dense(x, table.T, act_axis=0)
    want = ops.quant_dense(x.cpu(), table.cpu().T, act_axis=0)
    assert torch.equal(got.cpu(), want)


LIMIT_SHAPES = [(96, 256, 8), (96, 256, 1), (12288, 128, 1), (40, 1000, 1), (33, 64, 1),
                (7, 32, 7), (50, 200, 5)]


@pytest.mark.parametrize("rows,cols,per", LIMIT_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_nvu_softmax_limit_is_the_walk_bit_for_bit(dev, rows, cols, per, out_dtype):
    """A key limit per row or per `per` rows, limits from 0 to every
    column: the walk's bits, masked entries exactly 0, within the plain
    version's gate."""
    g = _gen(dev, 23)
    x = torch.randn(rows, cols, generator=g, device=dev) * 8
    limit = torch.randint(0, cols + 1, (rows // per,), generator=g, device=dev,
                          dtype=torch.int32)
    limit[0], limit[-1] = cols, 0
    before = LAUNCHES["nvu_softmax"]
    got = sm.nvu_softmax(x, limit=limit, out_dtype=out_dtype)
    _launched("nvu_softmax", before)
    want = sm.nvu_softmax_walk(x, limit=limit, out_dtype=out_dtype)
    assert torch.equal(_bits(got), _bits(want))
    assert bool((got[~sm.limit_mask(limit, rows, cols)] == 0).all())
    plain = sm.nvu_softmax_plain(x, limit=limit, out_dtype=out_dtype)
    _close(got, plain, 2e-5, BF16_RTOL if out_dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("segments", [8, 16])
def test_nvu_softmax_causal_limit_on_the_card(dev, segments):
    """A square causal matrix by limit (row r sees c <= r) on the card: its
    walk's bits; and the oracle's causal mode (-1e30, whose exp the -18
    clamp keeps) its own walk's bits, so the two differ where the table's
    exp at -18 is not 0 (8 segments) and agree where it is (16)."""
    x = torch.randn(1280, 128, generator=_gen(dev, 24), device=dev) * 3
    limit = (torch.arange(1280, device=dev) % 128 + 1).to(torch.int32)
    by_limit = sm.nvu_softmax(x, segments, limit=limit)
    by_rows = sm.nvu_softmax(x, segments, causal_rows=128)
    assert torch.equal(_bits(by_limit), _bits(sm.nvu_softmax_walk(x, segments, limit=limit)))
    assert torch.equal(_bits(by_rows), _bits(sm.nvu_softmax_walk(x, segments, causal_rows=128)))
    assert bool((by_limit[~sm.limit_mask(limit, 1280, 128)] == 0).all())
    assert torch.equal(by_limit, by_rows) == (segments == 16)

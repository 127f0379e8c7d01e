"""The prefix-table PWL evaluator of `csrc/pwl.cuh` against the walk.

The kernels' `npe_pwl` walks every interior knot, adding the slope and
intercept deltas of each knot x reaches.  `npe_pwl_prefix_n` instead sums
the deltas once, in order, into prefix rows P_slope / P_icept
(`npe_build_prefix_table`), finds seg(x) = the count of interior knots <= x
by binary lifting over the knots padded with NaN, and evaluates
P_slope[seg] * x + P_icept[seg].  Because the knots ascend, the two agree
bit for bit; this file checks that in numpy float32, step for step as the
kernel computes it, over every table of `_FUNCS` at 16 segments (the four
BERT runs, SiLU of the dense decoders, and the rest), and
checks `pwl_eval_walk` (the walk in torch ops, which the card's results are
held to) against it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pwl import _FUNCS, get_table
from repro_torch.kernels.pwl_eval import pack_table, pwl_eval_plain, pwl_eval_walk

NAMES = sorted(_FUNCS)
MANTISSA = ("recip", "rsqrt", "sqrt")      # evaluated on mantissas in [0.25, 1)
PREFIX_KNOTS = 128   # NPE_PREFIX_KNOTS in csrc/pwl.cuh
GUARD = np.float32(65536.0)


def _packed(name):
    return pack_table(get_table(name, 16)).astype(np.float32)


def walk(x, packed):
    """npe_pwl: slope_0 / icept_0 plus each delta whose knot x reaches."""
    s = packed.shape[1] - 1
    slope = np.full(x.shape, packed[1, 0], np.float32)
    icept = np.full(x.shape, packed[2, 0], np.float32)
    for i in range(1, s):
        hit = x >= packed[0, i]
        slope = np.where(hit, slope + packed[1, i], slope)
        icept = np.where(hit, icept + packed[2, i], icept)
    return slope * x + icept


def prefix_rows(packed):
    """npe_build_prefix_table: one float32 add per delta, in knot order."""
    s = packed.shape[1] - 1
    ps, pi = np.empty(s, np.float32), np.empty(s, np.float32)
    ps[0], pi[0] = packed[1, 0], packed[2, 0]
    for i in range(1, s):
        ps[i] = np.float32(ps[i - 1] + packed[1, i])
        pi[i] = np.float32(pi[i - 1] + packed[2, i])
    return ps, pi


def seg_by_lifting(x, packed):
    """npe_pwl_prefix_n's search: knots at [1..S-1] of a NaN-padded row,
    steps from the largest power of two <= S-1 down to 1, the first two
    against the knots every thread shares."""
    s = packed.shape[1] - 1
    knot = np.full(PREFIX_KNOTS, np.nan, np.float32)
    knot[1:s] = packed[0, 1:s]
    top = 1 << ((s - 1).bit_length() - 1) if s > 1 else 0
    k = np.zeros(x.shape, np.int64)
    if top:
        k = np.where(x >= knot[top], top, 0)
        step = top >> 1
        if step:
            kn = np.where(k != 0, knot[top + step], knot[step])
            k = np.where(x >= kn, k + step, k)
            step >>= 1
            while step:
                c = k + step
                k = np.where(x >= knot[c], c, k)
                step >>= 1
    return k


def prefix_eval(x, packed):
    ps, pi = prefix_rows(packed)
    k = seg_by_lifting(x, packed)
    return ps[k] * x + pi[k]


def sweep(packed, seed=0, n=200_000):
    """Seeded points over the table's range and beyond, plus every knot, the
    floats just below and above it, +-0, +-inf, NaN and the +-65536 guards."""
    rng = np.random.default_rng(seed)
    knots = packed[0, 1:packed.shape[1] - 1]
    lo, hi = float(knots.min()), float(knots.max())
    pts = [rng.uniform(lo - 1, hi + 1, n),
           rng.standard_normal(n) * 4,
           rng.standard_normal(n // 4) * 1e4,
           rng.uniform(0.25, 1.0, n // 4)]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, GUARD, -GUARD,
                        np.float32(3e38), np.float32(-3e38), np.float32(1e-40)], np.float32)
    edge = np.concatenate([knots, [GUARD, -GUARD]]).astype(np.float32)
    x = np.concatenate([np.asarray(p, np.float32) for p in pts] + [
        special, edge, np.nextafter(edge, np.float32(-np.inf)),
        np.nextafter(edge, np.float32(np.inf))])
    return x.astype(np.float32)


def _same_bits(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


@pytest.mark.parametrize("name", NAMES)
def test_knots_ascend(name):
    packed = _packed(name)
    knots = packed[0, 1:packed.shape[1] - 1]
    assert knots.size >= 1 and bool(np.all(np.diff(knots) > 0))
    assert packed.shape[1] <= PREFIX_KNOTS


@pytest.mark.parametrize("name", NAMES)
def test_lifting_counts_the_knots_below(name):
    """seg(x) is the count of interior knots <= x (0 for NaN)."""
    packed = _packed(name)
    x = sweep(packed, seed=1)
    knots = packed[0, 1:packed.shape[1] - 1]
    with np.errstate(invalid="ignore"):
        want = np.searchsorted(knots, x, side="right")
        want[np.isnan(x)] = 0
        got = seg_by_lifting(x, packed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_prefix_gather_equals_walk(name):
    packed = _packed(name)
    x = sweep(packed, seed=2)
    with np.errstate(invalid="ignore", over="ignore"):
        assert _same_bits(prefix_eval(x, packed), walk(x, packed))


@pytest.mark.parametrize("name", NAMES)
def test_torch_walk_is_the_walk(name):
    """`pwl_eval_walk` in float32 torch ops equals the numpy walk bit for
    bit, on float32 input and on bf16 input (widened exactly)."""
    packed = _packed(name)
    x = sweep(packed, seed=3, n=20_000)
    got = pwl_eval_walk(torch.from_numpy(x), torch.from_numpy(packed)).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        assert _same_bits(got, walk(x, packed))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = pwl_eval_walk(xb, torch.from_numpy(packed)).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        assert _same_bits(got_b, walk(xb.float().numpy(), packed))


@pytest.mark.parametrize("name", NAMES)
def test_torch_walk_computes_the_function(name):
    """The walk and the plain (gather) version differ only by the order of
    their roundings: within tests/test_kernels.py's 1e-5 on finite inputs."""
    packed = _packed(name)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(4096) * 4).astype(np.float32))
    if name in MANTISSA:
        x = torch.from_numpy(rng.uniform(0.25, 1.0, 4096).astype(np.float32))
    got = pwl_eval_walk(x, torch.from_numpy(packed))
    want = pwl_eval_plain(x[None], get_table(name, 16))[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def walk_slope(x, stab):
    """npe_pwl_slope: the slope table's row 1 at the count of interior knots
    (its row 0, the packed table's knots) that x reaches, one compare a knot."""
    s = stab.shape[1] - 1
    seg = np.zeros(x.shape, np.int64)
    for i in range(1, s):
        seg += x >= stab[0, i]
    return stab[1, seg]


@pytest.mark.parametrize("name", ["exp", "recip"])
def test_prefix_search_slope_is_the_walk_slope(name):
    """npe_pwl_prefix_slope_n (the softmax backward's) reads the slope at the
    segment its search finds: the slope npe_pwl_slope's walk gives, bit for
    bit, for the exp and recip tables, with the value beside it the walk's."""
    from repro_torch.kernels.pwl_eval import slope_table
    packed = _packed(name)
    stab = slope_table(name, 16, torch.device("cpu")).numpy()
    assert _same_bits(stab[0], packed[0])          # both search the packed table's knots
    x = sweep(packed, seed=5)
    with np.errstate(invalid="ignore", over="ignore"):
        k = seg_by_lifting(x, packed)
        assert _same_bits(stab[1][k], walk_slope(x, stab))
        assert _same_bits(prefix_eval(x, packed), walk(x, packed))

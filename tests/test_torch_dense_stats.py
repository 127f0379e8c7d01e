"""The dense mode's row statistics, which the forward writes and the
backward reads: `flash_attention.row_stats` (and `dense_attention_plain(...,
with_stats=True)`) against the row max and the norm that the reference's
`repro.core.nvu` computes over the visible scores (nvu_softmax's m, and
nvu_reciprocal of max(sum of nvu_exp(s - m), 1e-30); exact mode: the max
and max(sum of exp(s - m), 1e-30)); `dense_attention_grad_plain` gives the
same bits with the plain forward's statistics as without them; and the
models' attention (`ops.DenseAttentionFn`, whose forward now hands its
statistics to the backward) still gives jax.vjp's gradients of
`attention_scores` on the CPU.

Gates: the max exactly (the same f32 scores); the norm within 4 float32
ulps of the reference's (the sum of e runs in another order: torch's
against XLA's reduction); out bit for bit that of the call without
statistics; the gradients as `test_torch_dense_attention_grad.py` holds them
(1e-5 of a result's largest value, plus one bf16 ulp for a bf16 result).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nvu as ref_nvu
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import (dense_attention_grad_plain, dense_attention_plain,
                                                 dense_mask, row_stats)
from test_torch_dense_attention_grad import CASES, _case, _close, _port, _reference

# (name, b, hq, hkv, sq, skv, causal, window, pwl): self-attention with GQA and
# a window below the sequence, and cross attention with causality off
STATS_CASES = [
    ("causal-gqa", 2, 4, 2, 24, 24, True, 0, True),
    ("window", 1, 4, 1, 40, 40, True, 12, True),
    ("cross", 2, 2, 2, 8, 40, False, 0, True),
    ("causal-exact", 2, 4, 2, 24, 24, True, 0, False),
    ("window-exact", 1, 4, 1, 40, 40, True, 12, False),
]


def _scores(name, b, hq, hkv, sq, skv, seed=3):
    r = np.random.default_rng(seed)
    q = r.normal(0, 2, (b, hq, sq, 32)).astype(np.float32)
    k = r.normal(0, 1, (b, hkv, skv, 32)).astype(np.float32)
    kk = np.repeat(k, hq // hkv, axis=1)
    return q, k, (q @ kk.transpose(0, 1, 3, 2) * np.float32(32 ** -0.5)).astype(np.float32)


def _reference_stats(s, mask, pwl):
    """(m, norm) of each row as the reference's nvu functions give them."""
    xf = jnp.where(jnp.asarray(mask), jnp.asarray(s), -jnp.inf)
    m = jnp.max(xf, axis=-1, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    e = ref_nvu.nvu_exp(xf - m) if pwl else jnp.exp(xf - m)
    total = jnp.maximum(jnp.sum(jnp.where(jnp.asarray(mask), e, 0.0), axis=-1, keepdims=True),
                        1e-30)
    norm = ref_nvu.nvu_reciprocal(total) if pwl else total
    return np.asarray(m)[..., 0], np.asarray(norm)[..., 0]


@pytest.mark.parametrize("case", STATS_CASES, ids=[c[0] for c in STATS_CASES])
def test_row_stats_match_the_reference_nvu(case):
    name, b, hq, hkv, sq, skv, causal, window, pwl = case
    _, _, s = _scores(name, b, hq, hkv, sq, skv)
    mask = dense_mask(sq, skv, causal, window, "cpu")
    got = row_stats(torch.tensor(s), mask, pwl, 16)
    assert got.shape == (b, hq, sq, 2) and got.dtype == torch.float32
    m, norm = _reference_stats(s, mask.numpy(), pwl)
    assert np.array_equal(got[..., 0].numpy(), m)
    np.testing.assert_array_max_ulp(got[..., 1].numpy(), norm, maxulp=4)


@pytest.mark.parametrize("case", STATS_CASES, ids=[c[0] for c in STATS_CASES])
def test_plain_forward_returns_its_own_stats(case):
    """with_stats=True returns the same output and the statistics of the
    scores the forward computed (its own max and norm)."""
    name, b, hq, hkv, sq, skv, causal, window, pwl = case
    r = np.random.default_rng(4)
    q = torch.tensor(r.normal(0, 2, (b, hq, sq, 32)).astype(np.float32))
    k = torch.tensor(r.normal(0, 1, (b, hkv, skv, 32)).astype(np.float32)).to(torch.bfloat16)
    v = torch.tensor(r.normal(0, 1, (b, hkv, skv, 32)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, use_pwl=pwl)
    out, stats = dense_attention_plain(q, k, v, with_stats=True, **kw)
    assert torch.equal(out, dense_attention_plain(q, k, v, **kw))
    kk = k.repeat_interleave(hq // hkv, dim=1).to(torch.float32)
    s = torch.matmul(q, kk.transpose(-1, -2)) * 32 ** -0.5
    assert torch.equal(stats, row_stats(s, dense_mask(sq, skv, causal, window, "cpu"), pwl, 16))


@pytest.mark.parametrize("name", ["pwl", "exact", "bf16-q", "gqa-8-1", "window-below-seq",
                                  "cross", "softcap-50", "tied-maxima", "past-exp-clamp"])
def test_plain_backward_same_bits_with_stats(name):
    arrays, dtypes, kw = _case(**CASES[name])
    q, k, v, do = _port(arrays, dtypes)
    _, stats = dense_attention_plain(q, k, v, with_stats=True, out_dtype=v.dtype, **kw)
    for a, b in zip(dense_attention_grad_plain(q, k, v, do, stats=stats, **kw),
                    dense_attention_grad_plain(q, k, v, do, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["pwl", "exact", "window-below-seq", "softcap-50"])
def test_dense_attention_fn_cpu_route_matches_jax_vjp(name):
    """`ops.dense_attention` with gradients on the CPU: the forward's
    statistics reach the plain backward, whose gradients stay jax.vjp's of
    `attention_scores`; nothing is launched."""
    arrays, dtypes, kw = _case(**CASES[name])
    want = _reference(arrays, dtypes, kw)
    q, k, v, do = _port(arrays, dtypes)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = ops.dense_attention(*leaves, out_dtype=v.dtype, **kw)
    assert "DenseAttentionFn" in type(out.grad_fn).__name__
    out.backward(do)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)
    assert dict(LAUNCHES) == before

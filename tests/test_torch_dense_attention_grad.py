"""The backward of flash attention's dense mode against the reference's:
`dense_attention_grad_plain` (the CPU route of `dense_attention_grad`)
against `jax.vjp` of `repro.models.common.attention_scores` on the same
seeded q, k, v and output cotangent, in PWL and exact mode, f32 and bf16 q
over bf16 k and v (and f32 k and v, the CPU's float32 training path), GQA
1:1, 2:1 and 8:1, causal self-attention with the window below the
sequence (the window hides keys), causality off over more keys than
queries (cross attention), a logit soft cap of 50, rows whose scores all
tie (a zero query: every visible key is a maximum, the max's term split
evenly), and scores far past the exp table's clamp at -18.

Gates: a float32 result within F32_RTOL = 1e-5 of its largest value (the
same chain in float32, summed in another order; measured 1e-6); a bf16
result also within one bf16 ulp of each entry (at most 2^-7 of it, BF16_ULP):
jax rounds dq, dk, dv and the probabilities' cotangent to bf16 at the
points the plain version rounds at, and a sum in another order may land
on the other side of a rounding boundary.

Also: the CPU route of the models' attention (`ops.dense_attention` with
an operand that takes a gradient, `ops.DenseAttentionFn`) gives the plain
version's gradients bit for bit and launches nothing, under no_grad it
builds no graph, and the wrapper refuses with ValueError what it does not
take (a kv prefix of a cache, a head dim outside 32/64/128, a negative
window or cap, a cotangent of another shape).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_cm
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import (dense_attention_grad,
                                                 dense_attention_grad_plain,
                                                 dense_attention_plain)

F32_RTOL, BF16_ULP = 1e-5, 2.0 ** -7

CASES = {
    "pwl": dict(),
    "exact": dict(pwl=False),
    "bf16-q": dict(qdt="bfloat16"),
    "bf16-q-exact": dict(qdt="bfloat16", pwl=False),
    "f32-kv": dict(kvdt="float32"),
    "gqa-1-1": dict(hq=4, hkv=4),
    "gqa-8-1": dict(hq=8, hkv=1),
    "window-below-seq": dict(sq=48, skv=48, window=16),
    "window-exact": dict(sq=48, skv=48, window=16, pwl=False),
    "cross": dict(sq=8, skv=40, causal=False),
    "cross-exact": dict(sq=8, skv=40, causal=False, pwl=False),
    "softcap-50": dict(cap=50.0, qscale=8.0),
    "softcap-50-exact": dict(cap=50.0, qscale=8.0, pwl=False),
    "tied-maxima": dict(zero_rows=True),
    "past-exp-clamp": dict(qscale=30.0),
}


def _case(b=2, hq=4, hkv=2, sq=24, skv=24, d=32, causal=True, window=0, cap=0.0, pwl=True,
          qdt="float32", kvdt="bfloat16", qscale=1.0, zero_rows=False, seed=0):
    """Seeded operands in the reference's (B, S, H, D) layout and the kwargs."""
    r = np.random.default_rng(seed)
    q = r.normal(0, qscale, (b, sq, hq, d)).astype(np.float32)
    if zero_rows:
        q[:, ::3] = 0.0
    k = r.normal(0, 1, (b, skv, hkv, d)).astype(np.float32)
    v = r.normal(0, 1, (b, skv, hkv, d)).astype(np.float32)
    do = r.normal(0, 1, (b, sq, hq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, use_pwl=pwl)
    return (q, k, v, do), (qdt, kvdt), kw


def _reference(arrays, dtypes, kw):
    """jax.vjp of attention_scores: (dq, dk, dv) as float32 (B, H, S, D)."""
    q, k, v, do = arrays
    qdt, kvdt = dtypes
    cfg = dataclasses.replace(ref_get_config("glm4_9b", smoke=True), npe_pwl=kw["use_pwl"],
                              logit_softcap=kw["softcap"])
    sq, skv = q.shape[1], k.shape[1]

    def f(q_, k_, v_):
        return ref_cm.attention_scores(cfg, q_, k_, v_, window=kw["window"],
                                       causal=kw["causal"], q_offset=skv - sq)

    def vjp(q_, k_, v_, do_):
        out, back = jax.vjp(f, q_, k_, v_)
        return back(do_.astype(out.dtype))

    grads = jax.jit(vjp)(jnp.asarray(q, qdt), jnp.asarray(k, kvdt), jnp.asarray(v, kvdt),
                         jnp.asarray(do, kvdt))
    return [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3) for g in grads]


def _port(arrays, dtypes):
    """The operands as the port's (B, H, S, D) views, in the same dtypes."""
    qdt, kvdt = dtypes
    dts = (qdt, kvdt, kvdt, kvdt)
    return [torch.tensor(a).to(getattr(torch, dt)).permute(0, 2, 1, 3)
            for a, dt in zip(arrays, dts)]


def _close(got, want):
    g = got.float().numpy()
    gate = F32_RTOL * float(np.abs(want).max())
    if got.dtype == torch.bfloat16:
        gate = gate + BF16_ULP * np.maximum(np.abs(want), np.abs(g))
    err = np.abs(g - want)
    assert bool((err <= gate).all()), float((err - gate).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_vjp(name):
    arrays, dtypes, kw = _case(**CASES[name])
    want = _reference(arrays, dtypes, kw)
    q, k, v, do = _port(arrays, dtypes)
    got = dense_attention_grad_plain(q, k, v, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w)


def test_cases_cover_what_they_name():
    """The window hides keys, the cross case has more keys than queries,
    the zero rows tie at every visible key, and the large scores pass the
    exp table's clamp."""
    (q, k, v, _), _, kw = _case(**CASES["past-exp-clamp"])
    s = np.einsum("bqhd,bkhd->bhqk", q[:, :, :2], k) * 32 ** -0.5
    assert (s - s.max(-1, keepdims=True) < -18).any()
    (q, _, _, _), _, _ = _case(**CASES["tied-maxima"])
    assert not q[:, 0].any()
    c = CASES["window-below-seq"]
    assert c["window"] < c["sq"] == c["skv"]
    c = CASES["cross"]
    assert c["sq"] < c["skv"] and not c["causal"]


@pytest.mark.parametrize("name", ["pwl", "window-below-seq", "cross", "softcap-50"])
def test_models_attention_differentiates_through_the_plain_backward(name):
    """`ops.dense_attention` on CPU tensors that take gradients goes through
    `DenseAttentionFn`: its forward is the plain forward and its gradients
    are `dense_attention_grad_plain`'s, bit for bit; nothing is launched."""
    arrays, dtypes, kw = _case(**CASES[name])
    q, k, v, do = _port(arrays, dtypes)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = ops.dense_attention(*leaves, out_dtype=v.dtype, **kw)
    assert out.grad_fn is not None and "DenseAttentionFn" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), dense_attention_plain(q, k, v, out_dtype=v.dtype, **kw))
    out.backward(do)
    want = dense_attention_grad_plain(q, k, v, do, **kw)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert dict(LAUNCHES) == before
    with torch.no_grad():
        assert ops.dense_attention(*leaves, out_dtype=v.dtype, **kw).grad_fn is None


def test_backward_refuses_what_it_does_not_take():
    arrays, dtypes, kw = _case()
    q, k, v, do = _port(arrays, dtypes)
    with pytest.raises(ValueError, match="window"):
        dense_attention_grad(q, k, v, do, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        dense_attention_grad(q, k, v, do, softcap=-1.0)
    with pytest.raises(ValueError, match="do"):
        dense_attention_grad(q, k, v, do[:, :, :3])
    with pytest.raises(ValueError, match="head dim"):
        dense_attention_grad(q[..., :16], k[..., :16], v[..., :16], do[..., :16])
    with pytest.raises(ValueError):
        dense_attention_grad(q[:, :3], k, v, do[:, :3])          # 4 q heads over 2: 3 is no group
    with pytest.raises(ValueError):
        dense_attention_grad(q, k[:, :, :8], v[:, :, :8], do)     # fewer keys than queries
    # a decode step over the first 10 rows of a 24-row cache has no backward
    leaves = [t[:, :, :1].detach().clone().requires_grad_(True) for t in (q,)] + [k, v]
    out = ops.dense_attention(leaves[0], k, v, kv_len=10, out_dtype=v.dtype)
    with pytest.raises(ValueError, match="cache"):
        out.backward(torch.ones_like(out))

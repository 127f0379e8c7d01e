"""The flash kernel's dense mode (its plain version, which the CPU runs)
against the function it ports: the reference's `attention_scores` in its
cache case (`repro.models.common`, causal, q_offset = kv_len - Sq, k and v a
bf16 cache of which the rows past kv_len are not visible).  Both take the
same numpy-seeded inputs; the port's layout is (B, H, S, D).

Cache lengths cover each range of the kernel: one KV block of the old
blocked route (<= 256), one pass of the dense mode's tensor-core and 8-row
instances (257-1024) and several (> 1024; a single-row decode block holds
8192 keys in one pass); single-query steps and prefills; GQA and one kv head
a q head; PWL (NPE) and exact softmax; f32 and bf16 queries.

Tolerance: one bf16 ulp of the reference's output, plus 2^-7 of
sum_j p_j |v_j|.  The sums run in another order than XLA's, so a
probability can round to the neighbouring bf16 value (at most 2^-7 of
itself away) before P.V, and the output can round to the neighbouring bf16
value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_cm
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import dense_attention, dense_attention_plain

torch.set_float32_matmul_precision("highest")

# (b, hq, hkv, sq, kv_len, max_seq, d)
CASES = [
    (2, 4, 2, 1, 200, 256, 32),       # decode step, one old KV block
    (2, 4, 2, 1, 700, 768, 32),       # decode step, one dense pass
    (1, 4, 2, 1, 1500, 1536, 32),     # decode step, several passes
    (1, 4, 2, 64, 64, 128, 32),       # prefill at 0
    (1, 4, 4, 300, 300, 320, 64),     # prefill crossing 256
    (1, 4, 2, 16, 1200, 1300, 32),    # prefill of 16 rows over a long cache
    (2, 12, 12, 1, 2048, 2048, 64),   # BERT-base heads, several passes
]


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


def _inputs(case, q_bf16, seed=0):
    b, hq, hkv, sq, kv_len, max_seq, d = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, max_seq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, max_seq, hkv, d)).astype(np.float32)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return (bf(q) if q_bf16 else q), bf(k), bf(v)


def _port(q, k, v, kv_len, use_pwl, out_dtype=torch.bfloat16, fn=dense_attention_plain):
    qt = torch.from_numpy(q).permute(0, 2, 1, 3)
    kt, vt = (torch.from_numpy(a).to(torch.bfloat16).permute(0, 2, 1, 3) for a in (k, v))
    return fn(qt, kt, vt, kv_len=kv_len, use_pwl=use_pwl, out_dtype=out_dtype).permute(0, 2, 1, 3)


def _reference(q, k, v, kv_len, use_pwl, q_bf16):
    cfg = ref_get_config("bert_base", smoke=True)
    cfg = cfg.with_npe(8) if use_pwl else cfg
    qj = jnp.asarray(q, jnp.bfloat16 if q_bf16 else jnp.float32)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    out = ref_cm.attention_scores(cfg, qj, kj, vj, causal=True, q_offset=kv_len - q.shape[1])
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
def test_dense_plain_matches_attention_scores(case, use_pwl):
    kv_len = case[4]
    q, k, v = _inputs(case, q_bf16=False)
    want = _reference(q, k, v, kv_len, use_pwl, q_bf16=False)
    got = _port(q, k, v, kv_len, use_pwl)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    spread = _port(q, k, np.abs(v), kv_len, use_pwl, torch.float32).numpy()
    err = np.abs(got.float().numpy() - want)
    assert bool((err <= _bf16_ulp(want) + 2.0 ** -7 * spread).all()), float(err.max())


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
@pytest.mark.parametrize("use_pwl", [True, False])
def test_dense_plain_bf16_queries(case, use_pwl):
    """bf16 q, as the full-width model hands it over: the products are exact
    in f32 on both sides."""
    kv_len = case[4]
    q, k, v = _inputs(case, q_bf16=True, seed=1)
    want = _reference(q, k, v, kv_len, use_pwl, q_bf16=True)
    got = _port(q, k, v, kv_len, use_pwl)
    spread = _port(q, k, np.abs(v), kv_len, use_pwl, torch.float32).numpy()
    err = np.abs(got.float().numpy() - want)
    assert bool((err <= _bf16_ulp(want) + 2.0 ** -7 * spread).all()), float(err.max())


def test_dense_never_reads_past_kv_len():
    """Rows at or past kv_len are not visible: NaN there changes nothing."""
    q, k, v = _inputs(CASES[1], q_bf16=False, seed=2)
    want = _port(q, k, v, 700, True)
    k[:, 700:], v[:, 700:] = np.nan, np.nan
    assert torch.equal(_port(q, k, v, 700, True), want)


def test_dense_wrapper_cpu_route_is_the_plain_version():
    q, k, v = _inputs(CASES[3], q_bf16=False, seed=3)
    before = dict(LAUNCHES)
    for use_pwl in (True, False):
        want = _port(q, k, v, 64, use_pwl)
        assert torch.equal(_port(q, k, v, 64, use_pwl, fn=dense_attention), want)
        assert torch.equal(_port(q, k, v, 64, use_pwl, fn=ops.dense_attention), want)
    assert LAUNCHES == before


def test_dense_rounds_probabilities_to_the_cache_dtype():
    """With f32 k and v the probabilities stay f32: the bf16 cache is what
    rounds them, as `probs.astype(v.dtype)` does in the reference."""
    q, k, v = _inputs(CASES[0], q_bf16=False, seed=4)
    qt = torch.from_numpy(q).permute(0, 2, 1, 3)
    kt, vt = (torch.from_numpy(a).permute(0, 2, 1, 3) for a in (k, v))
    f32 = dense_attention_plain(qt, kt, vt, kv_len=200, out_dtype=torch.float32)
    bf = dense_attention_plain(qt, kt.to(torch.bfloat16), vt.to(torch.bfloat16), kv_len=200,
                               out_dtype=torch.float32)
    assert not torch.equal(f32, bf)
    assert float((f32 - bf).abs().max()) < 2.0 ** -7 * float(vt.abs().max())


def test_dense_wrapper_refuses_bad_shapes():
    q = torch.zeros(1, 4, 3, 32)
    k = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dense_attention(q, k, k, kv_len=2)          # kv_len < Sq
    with pytest.raises(ValueError):
        dense_attention(q, k, k, kv_len=9)          # past the cache
    with pytest.raises(ValueError):
        dense_attention(q, k[:, :, :, :16], k[:, :, :, :16])

"""The port's flash attention (its plain version, which the CPU runs) against
the reference: JAX `ops.flash_attention` in interpret mode where the JAX
kernel's mask is right (Sq == Skv, or decode with causal=False), and the
dense oracle `ref.attention` where it is not (causal with Sq < Skv: the JAX
kernel aligns query 0 with key 0, the oracle and the decode path align the
ends) or where the JAX kernel has no `kv_len` (compared with the oracle on
the sliced k/v).

Tolerances: 2e-5 with exact exp (tests/test_kernels.py's gate for the JAX
kernel against the oracle); 3e-5 with PWL exp, the reference's kernel-vs-
oracle gate for PWL routines.  Against the dense oracle, PWL runs within
one KV block only: across blocks the online rescale by pwl_exp(m_prev -
m_new) is not the dense softmax (pwl_exp(0) = 0.999), which is a property of
the reference's kernel that the port keeps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

FLOAT_TOL = 2e-5
PWL_TOL = 3e-5


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


def _port(q, k, v, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw).numpy()


def _max_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


PWL_MODES = [(False, 16, FLOAT_TOL), (True, 16, PWL_TOL), (True, 32, PWL_TOL)]


@pytest.mark.parametrize("use_pwl,segments,tol", PWL_MODES)
@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64)])
def test_causal_matches_jax_kernel(b, hq, hkv, s, d, use_pwl, segments, tol):
    q, k, v = _qkv(0, b, hq, hkv, s, s, d)
    kw = dict(causal=True, use_pwl=use_pwl, segments=segments, block_q=64, block_kv=64)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert _max_err(_port(q, k, v, **kw), want) <= tol


@pytest.mark.parametrize("use_pwl,segments,tol", PWL_MODES)
def test_window_matches_jax_kernel(use_pwl, segments, tol):
    q, k, v = _qkv(1, 1, 2, 2, 256, 256, 64)
    kw = dict(causal=True, window=64, use_pwl=use_pwl, segments=segments,
              block_q=64, block_kv=64)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert _max_err(_port(q, k, v, **kw), want) <= tol


@pytest.mark.parametrize("use_pwl,segments,tol", PWL_MODES)
def test_decode_matches_jax_kernel(use_pwl, segments, tol):
    q, k, v = _qkv(2, 2, 4, 2, 8, 512, 64)
    kw = dict(causal=False, use_pwl=use_pwl, segments=segments, block_q=8, block_kv=128)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert _max_err(_port(q, k, v, **kw), want) <= tol


@pytest.mark.parametrize("use_pwl,tol", [(False, FLOAT_TOL), (True, PWL_TOL)])
@pytest.mark.parametrize("sq,skv,window", [(1, 96, 0), (48, 128, 0), (64, 128, 32)])
def test_end_aligned_causal_matches_oracle(sq, skv, window, use_pwl, tol):
    """Sq < Skv, the last query aligned with the last key.  PWL in one block
    (block_kv = Skv); exact exp over blocks of 32."""
    q, k, v = _qkv(3, 2, 4, 2, sq, skv, 64)
    block_kv = skv if use_pwl else 32
    got = _port(q, k, v, causal=True, window=window, use_pwl=use_pwl,
                block_q=16, block_kv=block_kv)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         window=window, use_pwl=use_pwl)
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("use_pwl,tol", [(False, FLOAT_TOL), (True, PWL_TOL)])
@pytest.mark.parametrize("sq,kv_len,causal", [(1, 77, True), (1, 77, False),
                                              (13, 100, True), (8, 65, False)])
def test_kv_len_reads_the_cache_in_place(sq, kv_len, causal, use_pwl, tol):
    """kv_len not a multiple of the block: the same as the oracle over
    k[:, :, :kv_len]; the cache rows beyond are never read (filled with
    NaN here)."""
    q, k, v = _qkv(4, 2, 4, 2, sq, 128, 64)
    k[:, :, kv_len:] = np.nan
    v[:, :, kv_len:] = np.nan
    block_kv = 128 if use_pwl else 32
    got = _port(q, k, v, causal=causal, use_pwl=use_pwl, block_kv=block_kv,
                kv_len=kv_len)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k[:, :, :kv_len]),
                         jnp.asarray(v[:, :, :kv_len]), causal=causal, use_pwl=use_pwl)
    assert _max_err(got, want) <= tol


def test_pwl_across_blocks_follows_the_blocking():
    """With PWL exp the online softmax depends on the blocking: the port,
    like the JAX kernel, differs from the dense oracle across blocks (by
    ~5e-3 here) and agrees with the JAX kernel at the same blocking."""
    q, k, v = _qkv(5, 1, 2, 2, 8, 512, 64)
    kw = dict(causal=False, use_pwl=True, block_q=8, block_kv=128)
    got = _port(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert _max_err(got, ref_ops.flash_attention(jq, jk, jv, **kw)) <= PWL_TOL
    assert _max_err(got, ref.attention(jq, jk, jv, causal=False, use_pwl=True)) > 1e-3


def test_bf16_cache_and_out_dtype():
    """The decode path's types: f32 q over a bf16 cache, bf16 result; the
    same as the f32 computation on the bf16 values, rounded once."""
    q, k, v = _qkv(6, 2, 4, 2, 1, 64, 32)
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    got = ops.flash_attention(tq, tk, tv, kv_len=40, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 1, 32)
    want = flash_attention_plain(tq, tk.float(), tv.float(), kv_len=40, block_kv=64)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_ops_default_blocks_are_the_reference_defaults():
    """ops.flash_attention blocks at min(256, Skv) keys, as `ops.py` does."""
    q, k, v = _qkv(7, 1, 2, 2, 4, 384, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = flash_attention_plain(tq, tk, tv, causal=False, block_q=4, block_kv=256)
    assert torch.equal(got, want)
    want_small = flash_attention_plain(tq, tk[:, :, :128], tv[:, :, :128],
                                       causal=False, block_q=4, block_kv=128)
    got_small = ops.flash_attention(tq, tk[:, :, :128], tv[:, :, :128], causal=False)
    assert torch.equal(got_small, want_small)


def test_cpu_route_counts_no_launch_and_checks_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 4, 2, 2, 16, 32))
    before = LAUNCHES["flash_attention"]
    flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_len=1)         # fewer keys than queries
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :16], v[:, :, :, :16])
    with pytest.raises(ValueError):
        flash_attention(q[:, :3], k, v)            # 3 q-heads over 2 kv-heads

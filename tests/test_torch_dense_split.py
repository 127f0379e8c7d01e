"""The order of addition of the dense mode's decode instance, emulated.

`flash_dense_split_kernel` (csrc/flash_attention.cu) takes a call of at
most 8 rows a kv head by splitting each (batch, kv head)'s visible keys
across the blocks of a thread-block cluster (`dense_decode_split`).  The
PWL exp does not rescale, so the blocks keep the reference's three stages
and combine them in rank order: each row's max over the blocks' maxima;
e = exp(s - m) with that max and the row's sum, the blocks' partial sums
added in rank order; p = bf16(e * norm) with the cluster's norm, then the
blocks' P.V partials added in rank order.  This file computes that order in
float32 torch ops (the port's `nvu` functions for the PWL) at the decode
rows of chip_smoke.py [3] cut to batch 1, a windowed step whose window
starts inside a block's keys and a long cache, with the split the launch
rule gives for a 132-SM card and with the largest cluster, and holds it
  * to `dense_attention_plain` by the card's dense gate (2e-5 + one bf16
    ulp of the plain version's output + 2^-7 of sum_j p_j |v_j|: a
    probability may round to the neighbouring bf16 value), and
  * to the reference's `attention_scores` (src/repro/models/common.py) by
    the CPU tests' gate (one bf16 ulp of its output + 2^-7 of sum_j p_j |v_j|).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_cm
from repro_torch.core import nvu
from repro_torch.kernels.flash_attention import (NEG_BIG, SPLIT_MAX_CLUSTER, dense_attention_plain,
                                                 dense_decode_split, dense_mask, soft_cap)

torch.set_float32_matmul_precision("highest")

BF16_RTOL = 2.0 ** -7

# (name, hq, hkv, sq, kv_len, d, causal, window, softcap): chip_smoke.py's
# decode-instance rows (DENSE_ROWS, MASK_ROWS) at batch 1, then a window that
# starts inside a block's keys
ROWS = [
    ("bert kv 256", 12, 12, 1, 256, 64, True, 0, 0.0),
    ("bert kv 1024", 12, 12, 1, 1024, 64, True, 0, 0.0),
    ("bert kv 2048", 12, 12, 1, 2048, 64, True, 0, 0.0),
    ("bert kv 16384", 12, 12, 1, 16384, 64, True, 0, 0.0),
    ("gemma3 ring 1024", 32, 16, 1, 1024, 128, False, 0, 0.0),
    ("gemma3 ring 300", 32, 16, 1, 300, 128, False, 0, 0.0),
    ("gemma3 capped", 32, 16, 1, 1024, 128, True, 0, 50.0),
    ("hymba ring 32", 25, 5, 1, 32, 64, False, 0, 0.0),
    ("whisper cross 1500", 8, 8, 1, 1500, 64, False, 0, 0.0),
    ("granite 1024", 16, 8, 1, 1024, 64, True, 0, 0.0),
    ("windowed, 3 queries", 4, 2, 3, 2000, 64, True, 300, 0.0),
]


def _inputs(hq, hkv, sq, kv_len, d, softcap, seed):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q = bf(rng.standard_normal((1, sq, hq, d)).astype(np.float32)) * (8.0 if softcap else 1.0)
    k = bf(rng.standard_normal((1, kv_len, hkv, d)).astype(np.float32))
    v = bf(rng.standard_normal((1, kv_len, hkv, d)).astype(np.float32))
    return q, k, v


def split_order(q, k, v, *, kv_len, causal, window, softcap, use_pwl, slices, segments=16):
    """The decode instance's arithmetic in float32, block by block: q (B,
    Hq, Sq, D), k and v (B, Hkv, S, D) bf16, `slices` the (first key, end)
    of each block's keys in rank order; bf16 out."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    kk = k[:, :, :kv_len].repeat_interleave(group, dim=1).float()
    vv = v[:, :, :kv_len].repeat_interleave(group, dim=1).float()
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * (d ** -0.5)
    if softcap > 0:
        s = soft_cap(s, softcap, use_pwl, segments)
    mask = dense_mask(sq, kv_len, causal, window, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_BIG))
    # stage 1: each block's max of each row, then the cluster's
    m = None
    for lo, hi in slices:
        mb = s[..., lo:hi].amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG_BIG)
        m = mb if m is None else torch.maximum(m, mb)
    z = s - m[..., None]
    e = nvu.nvu_exp(z, segments) if use_pwl else torch.exp(z)
    e = torch.where(mask, e, 0.0)
    # stage 2: each block's sum, the blocks' in rank order
    total = torch.zeros(s.shape[:-1])
    for lo, hi in slices:
        total = total + e[..., lo:hi].sum(-1)
    total = torch.clamp(total, min=1e-30)
    p = (e * nvu.nvu_reciprocal(total, segments)[..., None] if use_pwl
         else e / total[..., None])
    p = p.to(torch.bfloat16).float()
    # stage 3: each block's P.V, the blocks' in rank order
    out = torch.zeros(b, hq, sq, d)
    for lo, hi in slices:
        out = out + torch.matmul(p[..., lo:hi], vv[:, :, lo:hi])
    return out.to(torch.bfloat16)


def _reference(q, k, v, *, kv_len, causal, window, softcap, use_pwl):
    cfg = dataclasses.replace(ref_get_config("bert_base", smoke=True), logit_softcap=softcap)
    cfg = cfg.with_npe(8) if use_pwl else cfg
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    qj = jnp.asarray(q, jnp.bfloat16)
    if causal:
        out = ref_cm.attention_scores(cfg, qj, kj, vj, window=window,
                                      q_offset=kv_len - q.shape[1])
    else:
        out = ref_cm.attention_scores(cfg, qj, kj, vj, causal=False)
    return np.asarray(out.astype(jnp.float32))


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
@pytest.mark.parametrize("use_pwl", [True, False], ids=["pwl", "exact"])
@pytest.mark.parametrize("split", ["launch rule", "largest cluster"])
def test_split_order_within_the_dense_gates(row, use_pwl, split):
    _, hq, hkv, sq, kv_len, d, causal, window, softcap = row
    inst, cs, slices = dense_decode_split(1, hq, hkv, sq, kv_len, window)
    assert inst >= hq // hkv * sq and len(slices) == cs
    if split == "largest cluster":
        _, cs, slices = dense_decode_split(1, hq, hkv, sq, kv_len, window, sms=10 ** 6)
        assert cs == max(1, min(SPLIT_MAX_CLUSTER, (slices[-1][1] - slices[0][0] + 63) // 256))
    # the blocks' keys tile the visible range in order
    assert slices[-1][1] == kv_len
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    q, k, v = _inputs(hq, hkv, sq, kv_len, d, softcap, seed=len(row[0]))
    qt = torch.from_numpy(q).permute(0, 2, 1, 3)
    kt, vt = (torch.from_numpy(a).to(torch.bfloat16).permute(0, 2, 1, 3) for a in (k, v))
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap, use_pwl=use_pwl)
    got = split_order(qt, kt, vt, slices=slices, **kw).float()
    spread = dense_attention_plain(qt, kt, vt.abs(), out_dtype=torch.float32, **kw)
    plain = dense_attention_plain(qt, kt, vt, out_dtype=torch.bfloat16, **kw).float()
    err = (got - plain).abs()
    assert bool((err <= 2e-5 + BF16_RTOL * plain.abs() + 2.0 ** -7 * spread).all()), \
        float(err.max())
    want = _reference(q, k, v, **kw)
    err = np.abs(got.permute(0, 2, 1, 3).numpy() - want)
    assert bool((err <= _ulp(want) + 2.0 ** -7 * spread.permute(0, 2, 1, 3).numpy()).all()), \
        float(err.max())


def test_split_rule_by_grid_and_cache():
    """A short cache takes one block (Hymba's 32 keys); a cache of many
    chunks over few heads the largest cluster; a grid that the largest
    cluster would overfill the largest cluster whose blocks the card holds
    at once (here 4 a SM on 132 SMs), unless that leaves a block more than
    16 chunks."""
    assert dense_decode_split(8, 25, 5, 1, 32)[:2] == (8, 1)
    assert dense_decode_split(1, 12, 12, 1, 16384)[:2] == (1, SPLIT_MAX_CLUSTER)
    assert dense_decode_split(8, 12, 12, 1, 2048)[1] == 5           # 96 heads: 5 x 96 <= 528
    assert dense_decode_split(8, 12, 12, 1, 2048, resident=3)[1] == 4
    assert dense_decode_split(8, 12, 12, 1, 16384)[1] == 8          # > 16 chunks a block at 5
    assert dense_decode_split(8, 32, 16, 1, 1024)[:2] == (2, 4)     # Gemma3's 2:1 group
    assert dense_decode_split(64, 32, 16, 1, 1024)[1] == 1          # 1024 heads fill the card
    assert dense_decode_split(8, 12, 12, 1, 256)[1] == 1            # 4 chunks: one block
    assert dense_decode_split(8, 12, 12, 1, 1024)[1] == 4           # 16 chunks: 4 a block
    assert dense_decode_split(8, 10, 2, 1, 300)[0] == 8             # 5 rows: the 8-row instance
    assert dense_decode_split(8, 8, 2, 1, 300)[0] == 4
    assert dense_decode_split(8, 32, 2, 1, 300) is None             # 16 rows: tensor-core tiles

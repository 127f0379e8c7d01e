"""Flash attention with the NVU's PWL exp and reciprocal (counterpart of
`repro/kernels/flash_attention.py` and of `ref.attention` in
`repro/kernels/ref.py`).

`flash_attention(q, k, v, ...)` launches `csrc/flash_attention.cu` for
tensors on the card and runs `flash_attention_plain` for tensors on the CPU.
The kernel picks its instance by dtype and shape: bf16 K/V with at most 8
query rows a kv head (decode) on the CUDA cores with the keys split across
warps, bf16 K/V with more rows on the bf16 tensor cores, f32 K/V on the CUDA
cores (see the source's note).
Both stream over KV blocks of `block_kv` keys with a running max and sum, as
`_flash_kernel` does: with PWL exp the result depends on the blocking (each
rescale multiplies by pwl_exp(m_prev - m_new), and pwl_exp(0) is not 1), so
the blocking is part of the function and the kernel keeps it.

`dense_attention(q, k, v, ...)` is the kernel's dense mode, the models'
attention: the reference's `attention_scores` (`repro/models/common.py`,
q_offset = kv_len - Sq), one softmax over every visible key with no running
rescale, the probabilities rounded to v's dtype before P.V.  It takes that
function's window, its causal switch (off: every key below kv_len, the ring
cache's prefix validity as a key count) and its logit soft cap.
`dense_attention_plain` is that arithmetic in torch ops.

A call with at most 8 rows a kv head (a GQA group's heads times its
queries) and no statistics takes the decode instance, which splits a
(batch, kv head)'s keys across the blocks of a thread-block cluster and
combines the blocks' row max, row sum and P.V partials in rank order;
`dense_decode_split` is its launch rule, `dense_decode_cluster` the cluster
a launch takes on the card.

With `with_stats=True` the dense mode also returns each row's statistics
(B, Hq, Sq, 2) f32: its max m over the visible scores and the norm its
probabilities were taken with (the PWL reciprocal of the sum, or the sum).

`dense_attention_grad(q, k, v, do, stats=...)` is the dense mode's backward
over the sequence itself (kv_len = Skv): (dq, dk, dv) as jax.vjp of
`attention_scores` gives them, from the forward's row statistics.  It
launches the same source's `npe_attention_dense_grad` (two kernels: a
64-row tile's statistics and dQ, then dK and dV a 64-key block, the GQA
group reduced in a cluster; see the source) for tensors on the card and
runs `dense_attention_grad_plain`, explicit torch formulas, on the CPU.

Layout (B, H, S, D), as in the reference.  The mask is end-aligned, as in
`ref.attention` and the decode path: of `kv_len` visible keys, query i sits
at position kv_len - Sq + i.  Keys at or beyond `kv_len` are invisible, so
decode reads a (B, H, max_seq, D) cache in place.  With causal=True a query
sees keys at positions <= its own; with window > 0 only keys at positions
> its own - window.  GQA maps q-head h to kv-head h // (Hq // Hkv).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from repro_torch.core import nvu
from repro_torch.core.pwl import get_table
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.kernels.nvu_softmax import softmax_where_grad_plain
from repro_torch.kernels.pwl_eval import (clip_factor, device_table, pwl_slope_plain,
                                          slope_table, table_ends)

NEG_BIG = -1e30
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)     # template instances of the kernel
MAX_BLOCK_KV = 1024           # one block's scores live in shared memory
# the dense mode's decode instance (csrc/flash_attention.cu, spl_split)
DECODE_ROWS = 8               # rows a kv head it takes
SPLIT_CHUNK = 64              # keys a staged chunk: a block takes whole chunks
SPLIT_MAX_CLUSTER = 8         # blocks a cluster at most
SPLIT_LONG = 16               # chunks a block past which the largest cluster is taken


def dense_decode_split(batch: int, hq: int, hkv: int, sq: int, kv_len: int, window: int = 0,
                       sms: int = 132, resident: int = 4):
    """The launch rule of the dense mode's decode instance, for a card of
    `sms` SMs that holds `resident` of its blocks a SM at once: (its rows,
    1, 2, 4 or 8; the blocks of a (batch, kv head)'s cluster; [(first key,
    end) of each block's keys in rank order]), or None for a call of more
    than DECODE_ROWS rows a kv head.  The visible keys (from the first row's
    window on) are cut into SPLIT_CHUNK-key chunks and the chunks shared out
    evenly; the cluster is the largest, at most SPLIT_MAX_CLUSTER blocks and
    at least four chunks a block, whose blocks the card holds at once, unless
    that leaves a block more than SPLIT_LONG chunks: then the largest.  The
    card holds about sms * resident / c clusters of c blocks at once; on the
    card the count is the occupancy calculator's for the compiled instance
    at the call's shared memory (a cluster's blocks share a GPC), and
    `dense_decode_cluster` reads the split the launch takes."""
    rows = hq // hkv * sq
    if rows > DECODE_ROWS:
        return None
    instance = 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8
    kv_lo = max(0, kv_len - sq - window + 1) if window > 0 else 0
    chunks = -(-(kv_len - kv_lo) // SPLIT_CHUNK)
    most = max(1, min(SPLIT_MAX_CLUSTER, chunks // 4))
    cs = next((c for c in range(most, 1, -1) if batch * hkv * c <= sms * resident), 1)
    if -(-chunks // cs) > SPLIT_LONG:
        cs = most
    slices = [(min(kv_len, kv_lo + chunks * r // cs * SPLIT_CHUNK),
               min(kv_len, kv_lo + chunks * (r + 1) // cs * SPLIT_CHUNK)) for r in range(cs)]
    return instance, cs, slices


def dense_decode_cluster(batch: int, hq: int, hkv: int, sq: int, kv_len: int, window: int,
                         d: int) -> int:
    """On the card: the blocks a cluster of the decode instance takes a
    (batch, kv head) for such a `dense_attention` call, as its launch
    computes them (0: the call takes a tensor-core instance)."""
    return library().npe_attention_dense_split(batch, hq, hkv, sq, kv_len, window, d)


def block_runs(q_lo: int, q_hi: int, kv_start: int, block_kv: int, kv_len: int,
               causal: bool, window: int) -> bool:
    """Whether the kv block at kv_start is computed for the q block whose
    positions are q_lo..q_hi: `_flash_kernel`'s rule (a causal block is
    skipped when it starts after the last query, a windowed one when it ends
    before the first query's window), plus blocks past kv_len.  A skipped
    block leaves the running max, sum and accumulator as they were."""
    run = kv_start < kv_len
    if causal:
        run = run and kv_start <= q_hi
        if window > 0:
            run = run and kv_start + block_kv - 1 >= q_lo - window + 1
    return run


def _vector_rows(t: torch.Tensor) -> torch.Tensor:
    """k or v as the bf16 instances read it: rows of D contiguous values at
    16-byte-aligned addresses (the decode cache's permuted views are).  Any
    other layout is copied into that one before the launch."""
    ok = (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _exp(z: torch.Tensor, use_pwl: bool, segments: int) -> torch.Tensor:
    """`_exp_fn`: clamp at -18, the PWL table with its edge segments, floored
    at 0; or exp."""
    if use_pwl:
        z = torch.clamp(z, min=-18.0)
        return torch.clamp(nvu.pwl_eval(z, get_table("exp", segments)), min=0.0)
    return torch.exp(z)


def _check_operands(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int]) -> int:
    """Raise on shapes the kernel does not take; return kv_len (default Skv)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} over k {tuple(k.shape)}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not sq <= kv_len <= skv:
        raise ValueError(f"{name}: kv_len {kv_len} outside [{sq}, {skv}]")
    return kv_len


def _check_card(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v lie on one CUDA device."""
    require_cuda(q, name)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None, use_pwl: bool = True,
                          segments: int = 16, block_q: int = 256,
                          block_kv: int = 256, kv_len: Optional[int] = None,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, one (q block, kv block) at a time."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    kv_len = skv if kv_len is None else kv_len
    scale = float(scale if scale is not None else d ** -0.5)
    group = hq // hkv
    off = kv_len - sq
    kk = k.repeat_interleave(group, dim=1).to(torch.float32)
    vv = v.repeat_interleave(group, dim=1).to(torch.float32)
    qs = q.to(torch.float32) * scale
    out = torch.empty(b, hq, sq, d, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        rows = torch.arange(q0, q1, device=q.device)[:, None] + off
        m = torch.full((b, hq, q1 - q0, 1), NEG_BIG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hq, q1 - q0, d, device=q.device)
        for k0 in range(0, kv_len, block_kv):
            if not block_runs(off + q0, off + q1 - 1, k0, block_kv, kv_len,
                              causal, window):
                continue
            k1 = min(k0 + block_kv, kv_len)     # keys past kv_len are never read
            s = torch.matmul(qs[:, :, q0:q1], kk[:, :, k0:k1].transpose(-1, -2))
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            mask = torch.ones_like(s, dtype=torch.bool)
            if causal:
                mask = mask & (cols <= rows)
            if window > 0:
                mask = mask & (cols > rows - window)
            s = torch.where(mask, s, NEG_BIG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = _exp(m - m_new, use_pwl, segments)
            p = torch.where(mask, _exp(s - m_new, use_pwl, segments), 0.0)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            acc = corr * acc + torch.matmul(p, vv[:, :, k0:k1])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        # nvu_reciprocal takes the mantissa and exponent by frexp/ldexp; for
        # l >= 1e-30 (a normal float) that is the kernels' bit trick exactly
        inv = nvu.nvu_reciprocal(l, segments) if use_pwl else 1.0 / l
        out[:, :, q0:q1] = acc * inv
    return out.to(out_dtype or q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, use_pwl: bool = True,
                    segments: int = 16, block_q: int = 256, block_kv: int = 256,
                    kv_len: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Skv, D); Hq % Hkv == 0.

    The result is (B, Hq, Sq, D) in `out_dtype` (default q's).  On the card
    the operands may be any strided views (the decode path hands it permuted
    views of its (B, S, H, D) cache and projections); the result is a
    (B, Hq, Sq, D) view of (B, Sq, Hq, D) memory, so that the caller's
    reshape back to (B, Sq, Hq * D) needs no copy."""
    kv_len = _check_operands("flash_attention", q, k, v, kv_len)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"flash_attention: blocks {block_q}, {block_kv}")
    out_dtype = out_dtype or q.dtype
    kw = dict(causal=causal, window=window, scale=scale, use_pwl=use_pwl,
              segments=segments, block_q=block_q, block_kv=block_kv,
              kv_len=kv_len, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    _check_card("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(f"flash_attention: {name} of {t.dtype}, not in {KERNEL_DTYPES}")
    if k.dtype != v.dtype or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention: k {k.dtype}, v {v.dtype}, out {out_dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if block_kv > MAX_BLOCK_KV:
        raise ValueError(f"flash_attention: block_kv {block_kv} > {MAX_BLOCK_KV}")
    if k.dtype == torch.bfloat16:
        k, v = _vector_rows(k), _vector_rows(v)
    out = torch.empty(b, sq, hq, d, dtype=out_dtype, device=q.device).permute(0, 2, 1, 3)
    et = device_table("exp", segments, q.device)
    rt = device_table("recip", segments, q.device)
    bf = lambda t: int(t.dtype == torch.bfloat16)
    scale = float(scale if scale is not None else d ** -0.5)
    err = library().npe_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride(), *k.stride(), *v.stride(), *out.stride(),
        b, hq, hkv, sq, skv, d, kv_len, bf(q), bf(k), bf(out),
        int(causal), window, scale, int(use_pwl), block_q, block_kv,
        et.data_ptr(), et.shape[1] - 1, rt.data_ptr(), rt.shape[1] - 1,
        stream_handle(q))
    check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def dense_mask(sq: int, kv_len: int, causal: bool, window: int, device) -> torch.Tensor:
    """The (Sq, kv_len) visibility of `attention_scores`, end-aligned: query i
    at position kv_len - Sq + i sees key j iff j <= its position (when
    causal) and j > its position - window (when window > 0)."""
    rows = torch.arange(sq, device=device)[:, None] + (kv_len - sq)
    cols = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones(sq, kv_len, dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return mask


def soft_cap(s: torch.Tensor, cap: float, use_pwl: bool, segments: int) -> torch.Tensor:
    """`attention_scores`' logit soft cap on f32 scores: cap * tanh(s / cap),
    tanh the NVU's (`nvu_tanh`, the PWL table clamped to its end knots) or
    exact."""
    t = s / cap
    return cap * (nvu.nvu_tanh(t, segments) if use_pwl else torch.tanh(t))


def row_stats(s: torch.Tensor, mask: torch.Tensor, use_pwl: bool, segments: int) -> torch.Tensor:
    """(..., 2) f32: each row's max m over the visible scores of s and the
    norm its probabilities are taken with, as `core/nvu.softmax` computes
    them: the PWL reciprocal of max(sum of e, 1e-30), e the NVU exp of s - m
    (PWL), or max(sum of exp(s - m), 1e-30) (exact).  A row that sees no
    key has m 0."""
    xs = torch.where(mask, s, -torch.inf)
    m = xs.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = nvu.nvu_exp(xs - m, segments) if use_pwl else torch.exp(xs - m)
    total = torch.clamp(torch.where(mask, e, 0.0).sum(dim=-1, keepdim=True), min=1e-30)
    norm = nvu.nvu_reciprocal(total, segments) if use_pwl else total
    return torch.cat([m, norm], dim=-1)


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_len: Optional[int] = None, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None,
                          use_pwl: bool = True, segments: int = 16,
                          out_dtype: Optional[torch.dtype] = None, with_stats: bool = False):
    """The dense mode's arithmetic in PyTorch, as `attention_scores` computes
    it: f32 scores (q . k) * scale, soft-capped when softcap > 0, the keys
    `dense_mask` hides masked, the NVU softmax (or exact softmax) over all
    visible keys at once, the probabilities cast to v's dtype, then P.V
    accumulated in f32.  With `with_stats`, (out, `row_stats`)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    kv_len = k.shape[2] if kv_len is None else kv_len
    scale = float(scale if scale is not None else d ** -0.5)
    group = hq // hkv
    kk = k[:, :, :kv_len].repeat_interleave(group, dim=1).to(torch.float32)
    vv = v[:, :, :kv_len].repeat_interleave(group, dim=1)
    s = torch.matmul(q.to(torch.float32), kk.transpose(-1, -2)) * scale
    if softcap > 0:
        s = soft_cap(s, softcap, use_pwl, segments)
    mask = dense_mask(sq, kv_len, causal, window, q.device)
    p = nvu.softmax(s, use_pwl=use_pwl, segments=segments, where=mask)
    out = torch.matmul(p.to(v.dtype).to(torch.float32), vv.to(torch.float32))
    out = out.to(out_dtype or q.dtype)
    return (out, row_stats(s, mask, use_pwl, segments)) if with_stats else out


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_len: Optional[int] = None, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    use_pwl: bool = True, segments: int = 16,
                    out_dtype: Optional[torch.dtype] = None, with_stats: bool = False):
    """Attention of q (B, Hq, Sq, D) over the first kv_len keys of bf16 k, v
    (B, Hkv, Skv, D), query i at position kv_len - Sq + i: the counterpart of
    `attention_scores` over a KV cache or over the sequence itself.  Each
    query sees the keys at or before its position (`causal`; with causality
    off, all kv_len) and after its position - `window` (window > 0); scores
    are soft-capped at `softcap` (> 0).  On the card the operands may be
    strided views, as for `flash_attention`, and the result is a (B, Hq, Sq,
    D) view of (B, Sq, Hq, D) memory.  With `with_stats`, (out, stats): the
    kernel also writes each row's (m, norm) (`row_stats`), which the
    backward reads; such a call takes the tensor-core instance at any shape.
    Each launch counts as one of `flash_attention`'s: it is a mode of the
    same kernel source."""
    kv_len = _check_operands("dense_attention", q, k, v, kv_len)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out_dtype = out_dtype or q.dtype
    if window < 0 or not softcap >= 0:
        raise ValueError(f"dense_attention: window {window}, softcap {softcap}")
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap, scale=scale,
              use_pwl=use_pwl, segments=segments, out_dtype=out_dtype, with_stats=with_stats)
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, **kw)
    _check_card("dense_attention", q, k, v)
    if q.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"dense_attention: q {q.dtype}, out {out_dtype}, not in {KERNEL_DTYPES}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"dense_attention: k {k.dtype}, v {v.dtype}; the cache is bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"dense_attention: head dim {d} not in {HEAD_DIMS}")
    k, v = _vector_rows(k), _vector_rows(v)
    out = torch.empty(b, sq, hq, d, dtype=out_dtype, device=q.device).permute(0, 2, 1, 3)
    stats = (torch.empty(b, hq, sq, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    et = device_table("exp", segments, q.device)
    rt = device_table("recip", segments, q.device)
    tt = device_table("tanh", segments, q.device)
    knots = get_table("tanh", segments).knots
    scale = float(scale if scale is not None else d ** -0.5)
    err = library().npe_attention_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride(), *k.stride(), *v.stride(), *out.stride(),
        b, hq, hkv, sq, skv, d, kv_len, int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(causal), int(window), scale, float(softcap),
        int(use_pwl), et.data_ptr(), et.shape[1] - 1, rt.data_ptr(), rt.shape[1] - 1,
        tt.data_ptr(), tt.shape[1] - 1, float(knots[0]), float(knots[-1]),
        stats.data_ptr() if with_stats else None, stream_handle(q))
    check(err, "dense_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, stats) if with_stats else out


def dense_attention_grad_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               do: torch.Tensor, *, causal: bool = True, window: int = 0,
                               softcap: float = 0.0, scale: Optional[float] = None,
                               use_pwl: bool = True, segments: int = 16,
                               stats: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of `dense_attention_plain(q, k, v, ...)` over all Skv keys
    against do (the output's cotangent), in q's, k's and v's dtypes: what
    jax.vjp of the reference's `attention_scores` gives, as explicit torch
    formulas.  For one query row over its visible keys (PWL mode):

        s_j = scale (q . k_j);  t_j = c tanh(s_j / c) when c > 0
        p = nvu_softmax(t, where=visible);  p^_j = p_j in v's dtype
        out = sum_j p^_j v_j

    and back: dp^_j = do . v_j, rounded to v's dtype (the cotangent of the
    bf16 probabilities as jax's transpose of the P.V einsum rounds it);
    dv_j = sum over the GQA group's rows of p^_ij do_i, rounded to v's dtype
    once; dt = the softmax's gradient (`softmax_where_grad_plain`: the
    reciprocal's slope through frexp/ldexp, each exp's segment slope, 0 past
    the clamp, the row max's term split evenly among tied maxima) or, exact,
    jax.nn.softmax's, p (dp - sum p dp); the cap: ((dt c) tanh'(s / c)) / c
    with tanh' the table's slope at the clipped s / c (1/2 at an end knot, 0
    past it) or jnp.tanh's (1 + t)(1 - t); dS = ds * scale; dq = dS . k
    rounded to q's dtype, dk = sum over the group of dS^T q rounded to k's
    dtype once (jax's transpose of the f32-accumulating score einsum converts
    its f32 result to the operand's dtype).  Those are every point where
    jax rounds a cotangent (`jax.vjp` of `repro.models.common.
    attention_scores` on the CPU); everything else is float32.  `stats`, the
    forward's `row_stats` (B, Hq, Sq, 2), gives the PWL softmax's row max and
    reciprocal in place of their recomputation: with the plain forward's own
    statistics, the same bits (the exact softmax needs neither)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1).to(torch.float32)
    raw = torch.matmul(q.to(torch.float32), kk.to(torch.float32).transpose(-1, -2)) * scale
    s = soft_cap(raw, softcap, use_pwl, segments) if softcap > 0 else raw
    mask = dense_mask(sq, skv, causal, window, q.device)
    dof = do.to(torch.float32)
    p = nvu.softmax(s, use_pwl=use_pwl, segments=segments, where=mask)
    ph = p.to(v.dtype).to(torch.float32)
    dv = torch.matmul(ph.transpose(-1, -2), dof)                       # b hq kv d
    dv = dv.reshape(b, hkv, group, skv, d).sum(2).to(v.dtype)
    dp = torch.matmul(dof, vv.transpose(-1, -2)).to(v.dtype).to(torch.float32)
    if use_pwl:
        row_max, row_inv = (None, None) if stats is None else (stats[..., :1], stats[..., 1:])
        dt = softmax_where_grad_plain(s, dp, mask, segments, row_max, row_inv)
    else:
        dt = p * dp + p * (-(p * dp).sum(dim=-1, keepdim=True))
    if softcap > 0:
        g = dt * softcap
        if use_pwl:
            u = raw / softcap
            lo, hi = table_ends("tanh", segments)
            g = g * pwl_slope_plain(torch.clamp(u, lo, hi), get_table("tanh", segments))
            g = g * clip_factor(u, lo, hi)
        else:
            t = torch.tanh(raw / softcap)
            g = (g + g * t) * (1 - t)
        dt = g / softcap
    ds = dt * scale
    dq = torch.matmul(ds, kk.to(torch.float32)).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(torch.float32))
    dk = dk.reshape(b, hkv, group, skv, d).sum(2).to(k.dtype)
    return dq, dk, dv


GRAD_RTOL = 1e-4     # the backward kernel against its plain version, of a result's largest value


def dense_attention_grad_gates(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               do: torch.Tensor, want, **kw) -> List[float]:
    """The gate of each of the backward kernel's (dq, dk, dv) against `want`,
    the plain backward's on the same operands and options `kw`: max(GRAD_RTOL
    of the result's largest value, twice the plain backward's own change
    when the score scale moves ceil(sqrt(D)) float32 ulps up or down); a
    bf16 result may differ by one bf16 ulp of each entry besides.  The
    kernel sums each score's D products in another order than torch's
    product, so the two scores differ by the rounding of D additions, up to
    about sqrt(D) ulps: a bf16 probability or cotangent may round to its
    neighbour, and where a row's two largest scores lie within that of each
    other, or a score next to one of the exp table's knots, the PWL
    derivative jumps (through the row max's term, by up to a few percent
    of the largest gradient, in one row).  The scale's nudge moves every
    score by as much, and shows what that does to the plain version: at
    Granite's (4, 16 over 8, 1024, 64) its dq moves by 0.018 under 2 or 4
    ulps and 0.13 under 8, where the kernel's differs by 0.036 (H100)."""
    scale = torch.tensor(kw.pop("scale", None) or q.shape[-1] ** -0.5, dtype=torch.float32)
    moved = []
    for way in (math.inf, -math.inf):
        s = scale
        for _ in range(math.ceil(q.shape[-1] ** 0.5)):
            s = torch.nextafter(s, torch.tensor(way))
        moved.append(dense_attention_grad_plain(q, k, v, do, scale=float(s), **kw))
    return [max(GRAD_RTOL * float(w.float().abs().max()),
                2 * max(float((m[i].float() - w.float()).abs().max()) for m in moved))
            for i, w in enumerate(want)]


def _check_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                window: int, softcap: float, stats: Optional[torch.Tensor]) -> None:
    """Raise ValueError on what the dense mode's backward does not take."""
    _check_operands("dense_attention_grad", q, k, v, None)
    if do.shape != q.shape:
        raise ValueError(f"dense_attention_grad: do {tuple(do.shape)}, q {tuple(q.shape)}")
    if stats is not None and (stats.shape != (*q.shape[:3], 2) or stats.dtype != torch.float32):
        raise ValueError(f"dense_attention_grad: stats {tuple(stats.shape)} {stats.dtype}, "
                         f"not {(*q.shape[:3], 2)} float32")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"dense_attention_grad: head dim {q.shape[3]} not in {HEAD_DIMS}")
    if window < 0 or not softcap >= 0:
        raise ValueError(f"dense_attention_grad: window {window}, softcap {softcap}")


def dense_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                         *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                         scale: Optional[float] = None, use_pwl: bool = True,
                         segments: int = 16, stats: Optional[torch.Tensor] = None):
    """The backward of `dense_attention(q, k, v, ...)` over all Skv keys
    (kv_len = Skv, query i at position Skv - Sq + i) against do, the
    output's cotangent: (dq, dk, dv) in q's, k's and v's dtypes.  Takes q
    (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) with D in HEAD_DIMS, GQA,
    causal on or off, window >= 0, softcap >= 0 (ValueError otherwise); on
    the card q in f32 or bf16, k, v and do in bf16 (do in v's dtype, as the
    forward returns it), any strided views, and `stats`, the row statistics
    that `dense_attention(..., with_stats=True)` returned on the same
    operands (required: the kernel reads the forward's row max and norm and
    does not recompute them).  Each launch counts as one of
    `flash_attention_grad`'s."""
    _check_grad(q, k, v, do, window, softcap, stats)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, use_pwl=use_pwl,
              segments=segments)
    if q.device.type == "cpu":
        return dense_attention_grad_plain(q, k, v, do, stats=stats, **kw)
    _check_card("dense_attention_grad", q, k, v)
    if do.device != q.device:
        raise ValueError(f"dense_attention_grad: do on {do.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != torch.bfloat16 for t in (k, v, do)):
        raise ValueError(f"dense_attention_grad: q {q.dtype}, k {k.dtype}, v {v.dtype}, "
                         f"do {do.dtype}; the kernel takes f32 or bf16 q and bf16 k, v, do")
    if stats is None or stats.device != q.device:
        raise ValueError("dense_attention_grad: the kernel reads the forward's row statistics: "
                         "pass stats= from dense_attention(..., with_stats=True) on the card")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    q, k, v, do = _vector_rows(q), _vector_rows(k), _vector_rows(v), _vector_rows(do)
    dev = q.device
    dq = torch.empty(b, hq, sq, d, dtype=q.dtype, device=dev)
    dk = torch.empty(b, hkv, skv, d, dtype=torch.bfloat16, device=dev)
    dv = torch.empty(b, hkv, skv, d, dtype=torch.bfloat16, device=dev)
    work = torch.empty(b, hq, sq, 4, dtype=torch.float32, device=dev)   # m, norm, dS, share
    tables = []
    for name in ("exp", "recip", "tanh"):
        packed = device_table(name, segments, dev)       # (3, S+1): S with the guard segments
        tables += [packed.data_ptr(), slope_table(name, segments, dev).data_ptr(),
                   packed.shape[1] - 1, *table_ends(name, segments)]
    scale = float(scale if scale is not None else d ** -0.5)
    err = library().npe_attention_dense_grad(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.contiguous().data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
        *q.stride(), *k.stride(), *v.stride(), *do.stride(),
        b, hq, hkv, sq, skv, d, int(q.dtype == torch.bfloat16), int(causal), int(window),
        scale, float(softcap), int(use_pwl), *tables, stream_handle(q))
    check(err, "dense_attention_grad")
    LAUNCHES["flash_attention_grad"] += 1
    return dq, dk, dv

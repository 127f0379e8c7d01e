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

Layout (B, H, S, D), as in the reference.  The mask is end-aligned, as in
`ref.attention` and the decode path: of `kv_len` visible keys, query i sits
at position kv_len - Sq + i.  Keys at or beyond `kv_len` are invisible, so
decode reads a (B, H, max_seq, D) cache in place.  With causal=True a query
sees keys at positions <= its own; with window > 0 only keys at positions
> its own - window.  GQA maps q-head h to kv-head h // (Hq // Hkv).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import nvu
from repro_torch.core.pwl import get_table
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, library, require_cuda, stream_handle
from repro_torch.kernels.pwl_eval import device_table

NEG_BIG = -1e30
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)     # template instances of the kernel
MAX_BLOCK_KV = 1024           # one block's scores live in shared memory


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


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          kv_len: Optional[int] = None, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None,
                          use_pwl: bool = True, segments: int = 16,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense mode's arithmetic in PyTorch, as `attention_scores` computes
    it: f32 scores (q . k) * scale, soft-capped when softcap > 0, the keys
    `dense_mask` hides masked, the NVU softmax (or exact softmax) over all
    visible keys at once, the probabilities cast to v's dtype, then P.V
    accumulated in f32."""
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
    return out.to(out_dtype or q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_len: Optional[int] = None, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    use_pwl: bool = True, segments: int = 16,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over the first kv_len keys of bf16 k, v
    (B, Hkv, Skv, D), query i at position kv_len - Sq + i: the counterpart of
    `attention_scores` over a KV cache or over the sequence itself.  Each
    query sees the keys at or before its position (`causal`; with causality
    off, all kv_len) and after its position - `window` (window > 0); scores
    are soft-capped at `softcap` (> 0).  On the card the operands may be
    strided views, as for `flash_attention`, and the result is a (B, Hq, Sq,
    D) view of (B, Sq, Hq, D) memory.  Each launch counts as one of
    `flash_attention`'s: it is a mode of the same kernel source."""
    kv_len = _check_operands("dense_attention", q, k, v, kv_len)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out_dtype = out_dtype or q.dtype
    if window < 0 or not softcap >= 0:
        raise ValueError(f"dense_attention: window {window}, softcap {softcap}")
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap, scale=scale,
              use_pwl=use_pwl, segments=segments, out_dtype=out_dtype)
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
        stream_handle(q))
    check(err, "dense_attention")
    LAUNCHES["flash_attention"] += 1
    return out

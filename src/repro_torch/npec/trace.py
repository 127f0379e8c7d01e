"""Tracers: BERT -> npec graph IR (counterpart of `repro/npec/trace.py`, its
BERT half).

The tracer is the compiler's front end: it walks a `ModelConfig` and emits
the per-sequence dataflow graph (`repro_torch.npec.ir`) that lowering maps
onto the overlay.  The BERT emitters mirror the port's `models/bert.py` op
for op, which is what makes the functional executor (`repro_torch.npec.exec`)
checkable against that model.  They are copies of the reference's, so both
packages compile a configuration to the same graph, node for node.

Three modes, as in the reference:
  * prefill (`trace_model`) — the whole sequence at once, per-head
    QK^T/softmax/AV over (S, S) scores (the bidirectional encoder);
  * decode  (`trace_decode`) — ONE new token against a KV cache of
    capacity T: skinny (1, H) projections, cache-append of the new k/v,
    a (g, T) QK^T over the cache, a pos-masked softmax and the AV
    reduction; batch=B merges B serving slots into one stream;
  * serving prefill (`trace_prefill`) — causal, with the logits head and
    kv exports that seed a decode slot; cache_len=T traces one chunked
    slice over the decode streams' cache banks.

The dense and moe families raise `CompileError`: they wait for their models
(ROADMAP queue 1, item 6).

CLI (on the card unless --device cpu):
    PYTHONPATH=src python -m repro_torch.npec.trace --model bert_base [--seq N | --decode T] \\
        [--bits 8|16] [--check]
prints the graph, its instruction counts by unit and the greedy and
streaming schedules' totals, which are cycles of the FPGA overlay model
(200 MHz), not time on a GPU.  --check holds the compiled encoder's cycles
within 1% of the hand-built program (`core.cycles.build_encoder_program`),
then runs the compiled stream through the executor and holds it against the
port's `models/bert`; it exits non-zero past either gate.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.npec.ir import Graph, GraphBuilder

_LATER = "(see ROADMAP.md queue 1, item 6: the dense and MoE families)"


class CompileError(NotImplementedError):
    """A model (or model feature) the compiler cannot lower yet."""


# ---------------------------------------------------------------------------
# BERT (paper Table 1): post-norm encoder
# ---------------------------------------------------------------------------

def _attention(b: GraphBuilder, x: int, l: int, *, S: int, H: int, A: int,
               KV: int, hd: int, qkv_bias: bool, causal: bool, tag: str,
               export_kv: bool = False) -> int:
    """Per-head multi-head attention; returns the output-projection node.

    Heads are emitted in plain dataflow order (q,k,v,qk,softmax,av per
    head) — deferring the AV matmuls past the next head's projections is
    the *scheduler's* job, not the tracer's.

    export_kv=True (serving prefill, `trace_prefill`) registers each kv
    head's (S, hd) k and v nodes in `Graph.kv_exports` under the decode
    streams' canonical cache names, so a slot's cache banks can be seeded
    from one prefill pass.
    """
    g = A // KV
    kv_nodes = {}
    z_heads = []
    for i in range(A):
        j = i // g                                  # shared kv head (GQA)
        cq = (i * hd, (i + 1) * hd)
        ck = (j * hd, (j + 1) * hd)
        bq = (b.param(("blocks", "bq"), (hd,), layer=l, cols=cq)
              if qkv_bias else None)
        q = b.matmul(x, b.param(("blocks", "wq"), (H, hd), layer=l, cols=cq),
                     bias=bq, tag=f"{tag}.h{i}.q")
        if j not in kv_nodes:
            bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
                  if qkv_bias else None)
            bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
                  if qkv_bias else None)
            k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                    cols=ck), bias=bk, tag=f"{tag}.h{i}.k")
            v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                    cols=ck), bias=bv, tag=f"{tag}.h{i}.v")
            kv_nodes[j] = (k, v)
            if export_kv:
                b.g.kv_exports[f"{tag}.kv{j}.k"] = k
                b.g.kv_exports[f"{tag}.kv{j}.v"] = v
        k, v = kv_nodes[j]
        qk = b.matmul(q, k, transpose_b=True, scale=hd ** -0.5,
                      tag=f"{tag}.h{i}.qk")
        sm = b.softmax(qk, causal=causal, tag=f"{tag}.h{i}.softmax")
        z_heads.append(b.matmul(sm, v, tag=f"{tag}.h{i}.av"))
    z = b.concat(z_heads, tag=f"{tag}.merge_heads")
    wo = b.param(("blocks", "wo"), (A * hd, H), layer=l)
    return b.matmul(z, wo, tag=f"{tag}.attn.out")


def _plain_mlp(b: GraphBuilder, x: int, l: int, *, H: int, F: int,
               mlp_bias: bool, act: str, tag: str) -> int:
    """GELU two-matmul MLP; returns the down projection (pre-residual)."""
    b1 = (b.param(("blocks", "mlp", "b1"), (F,), layer=l)
          if mlp_bias else None)
    ff1 = b.matmul(x, b.param(("blocks", "mlp", "w1"), (H, F), layer=l),
                   bias=b1, tag=f"{tag}.ff1")
    mid = b.act(ff1, act, tag=f"{tag}.act")
    b2 = (b.param(("blocks", "mlp", "b2"), (H,), layer=l)
          if mlp_bias else None)
    return b.matmul(mid, b.param(("blocks", "mlp", "w2"), (F, H), layer=l),
                    bias=b2, tag=f"{tag}.ff2")


def _post_norm_rest(b: GraphBuilder, x: int, proj: int, l: int, *, H: int,
                    F: int, eps: float, mlp_bias: bool, norm_beta: bool,
                    tag: str) -> int:
    """The post-norm sandwich after attention (paper Table 1):
    X2 = LN(X + attn); X4 = MLP(X2); X5 = LN(X2 + X4).  Shared by the
    prefill, decode, and dims-only BERT paths so the block structure
    cannot silently diverge between them."""
    def ln(inp, name, tagname):
        gamma = b.param(("blocks", name, "gamma"), (H,), layer=l)
        beta = (b.param(("blocks", name, "beta"), (H,), layer=l)
                if norm_beta else None)
        return b.layernorm(inp, gamma, beta, eps=eps, tag=tagname)
    ln_a = ln(b.add(x, proj, tag=f"{tag}.res_a"), "ln1", f"{tag}.ln_a")
    ff2 = _plain_mlp(b, ln_a, l, H=H, F=F, mlp_bias=mlp_bias, act="gelu",
                     tag=tag)
    res2 = b.add(ln_a, ff2, tag=f"{tag}.res_b")
    return ln(res2, "ln2", f"{tag}.ln_b")


def _bert_layer(b: GraphBuilder, x: int, l: int, *, S: int, H: int, A: int,
                KV: int, hd: int, F: int, eps: float, qkv_bias: bool,
                mlp_bias: bool, tag: str, causal: bool = False,
                export_kv: bool = False) -> int:
    proj = _attention(b, x, l, S=S, H=H, A=A, KV=KV, hd=hd,
                      qkv_bias=qkv_bias, causal=causal, tag=tag,
                      export_kv=export_kv)
    return _post_norm_rest(b, x, proj, l, H=H, F=F, eps=eps,
                           mlp_bias=mlp_bias, norm_beta=True, tag=tag)


def _embed(b: GraphBuilder, cfg: ModelConfig, tokens: int, pos: Optional[int],
           S: int) -> int:
    """Token + learned position + type-0 embeddings, then the embedding
    LayerNorm; positions [0, S) for the encoder, gathered at `pos` for the
    decode step and the chunked slice."""
    H = cfg.d_model
    x = b.embed(tokens, b.param(("embed",), (cfg.vocab_size, H)),
                tag="embed.tok")
    if pos is None:
        x = b.add(x, b.param(("pos_embed",), (S, H), rows=(0, S)),
                  tag="embed.pos")
    else:
        pe = b.embed(pos, b.param(("pos_embed",), (cfg.max_position, H)),
                     tag="embed.pos")
        x = b.add(x, pe, tag="embed.pos_add")
    x = b.add(x, b.param(("type_embed",), (H,), index=0), tag="embed.type")
    return b.layernorm(x, b.param(("ln_embed", "gamma"), (H,)),
                       b.param(("ln_embed", "beta"), (H,)),
                       eps=1e-12, tag="embed.ln")


def _trace_bert(cfg: ModelConfig, seq: int, layers: Optional[int],
                include_embed: bool, *, causal: bool = False,
                logits_head: bool = False, export_kv: bool = False) -> Graph:
    """causal/logits_head/export_kv are the *serving prefill* variant
    (`trace_prefill`): causal masking + a vocab head + kv exports mirror
    what an incremental `models/bert.decode_step` rollout over the prompt
    computes — the bidirectional default is the paper's encoder."""
    b = GraphBuilder()
    S, H, A, KV = seq, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    if include_embed:
        x = _embed(b, cfg, b.input("tokens", (S,), dtype="int32"), None, S)
    else:
        x = b.input("x", (S, H))
    for l in range(L):
        x = _bert_layer(b, x, l, S=S, H=H, A=A, KV=KV, hd=hd, F=F,
                        eps=1e-12, qkv_bias=cfg.qkv_bias,
                        mlp_bias=cfg.mlp_bias, tag=f"enc{l}",
                        causal=causal, export_kv=export_kv)
    if logits_head and include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def _require_bert(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "bert":
        raise CompileError(
            f"the port's npec has no {what} tracer for family {cfg.family!r} "
            f"({cfg.name!r}) yet {_LATER}")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def trace_model(cfg: ModelConfig, seq: int, *, layers: Optional[int] = None,
                include_embed: bool = True) -> Graph:
    """Emit the IR graph for `cfg` at sequence length `seq`.

    layers=N truncates the stack (cycle models usually compile one layer
    and scale); include_embed=False starts from a hidden-state input.
    """
    _require_bert(cfg, "prefill")
    return _trace_bert(cfg, seq, layers, include_embed)


def trace_bert_shape(shape, *, layers: int = 1) -> Graph:
    """Encoder-only graph from dims alone: any object with the attributes
    `seq`, `hidden`, `heads`, `head_dim` and `d_ff` (the reference's
    `core.cycles.BertShape`).  No biases: bias adds are folded and cost
    nothing, so the instruction stream is cycle-identical either way."""
    b = GraphBuilder()
    x = b.input("x", (shape.seq, shape.hidden))
    for l in range(layers):
        x = _bert_layer(b, x, l, S=shape.seq, H=shape.hidden,
                        A=shape.heads, KV=shape.heads, hd=shape.head_dim,
                        F=shape.d_ff, eps=1e-12, qkv_bias=False,
                        mlp_bias=False, tag=f"enc{l}")
    b.output(x)
    return b.g


# ---------------------------------------------------------------------------
# Decode-step tracers: one new token over a KV cache of capacity T
# ---------------------------------------------------------------------------

def _decode_attention(b: GraphBuilder, x: int, l: int, *, T: int, H: int,
                      A: int, KV: int, hd: int, qkv_bias: bool, pos: int,
                      tag: str, B: int = 1,
                      pos_slots: Optional[list] = None,
                      window: bool = False) -> int:
    """Cached one-token attention; returns the output-projection node.

    Per kv head: the new k/v appended into the (T, hd) cache at `pos`
    (MWU traffic, folded), the group's skinny (1, H) q projections stacked
    into (g, hd), a (g, T) QK^T over the cache, a pos-masked softmax, and
    the attention-weighted V reduction.

    B > 1 is the *batched* decode stream: B serving slots share one stream,
    so every weight projection is a single merged B-row MMU tile over the
    stacked slot states, `pos` is a (B,) vector, and each slot keeps its own
    cache bank (`{tag}.kv{j}.slot{s}.k/v`) with its own pos-masked
    QK^T/softmax/AV stream.  `pos_slots[s]` is the hoisted scalar
    slot_select of pos for softmax masking.

    window=True makes every cache bank a ring: the append wraps at T and
    the pos-masked softmax saturates to the full T-slot ring once pos >= T.
    """
    g = A // KV
    if B > 1:
        return _decode_attention_batched(
            b, x, l, T=T, H=H, A=A, KV=KV, hd=hd, qkv_bias=qkv_bias,
            pos=pos, pos_slots=pos_slots, tag=tag, B=B, window=window)
    z_groups = []
    for j in range(KV):
        ck = (j * hd, (j + 1) * hd)
        bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                cols=ck), bias=bk, tag=f"{tag}.kv{j}.k")
        v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                cols=ck), bias=bv, tag=f"{tag}.kv{j}.v")
        kc = b.cache(f"{tag}.kv{j}.k", (T, hd))
        vc = b.cache(f"{tag}.kv{j}.v", (T, hd))
        kc = b.cache_append(kc, k, pos, window=window)
        vc = b.cache_append(vc, v, pos, window=window)
        q_heads = []
        for gi in range(g):
            i = j * g + gi
            cq = (i * hd, (i + 1) * hd)
            bq = (b.param(("blocks", "bq"), (hd,), layer=l, cols=cq)
                  if qkv_bias else None)
            q_heads.append(b.matmul(x, b.param(("blocks", "wq"), (H, hd), layer=l,
                                               cols=cq), bias=bq, tag=f"{tag}.h{i}.q"))
        qg = (q_heads[0] if g == 1
              else b.concat(q_heads, axis=-2, tag=f"{tag}.kv{j}.qstack"))
        qk = b.matmul(qg, kc, transpose_b=True, scale=hd ** -0.5,
                      tag=f"{tag}.kv{j}.qk")
        sm = b.softmax(qk, valid_upto=pos, tag=f"{tag}.kv{j}.softmax")
        av = b.matmul(sm, vc, tag=f"{tag}.kv{j}.av")
        z_groups.append(av if g == 1
                        else b.reshape(av, (1, g * hd),
                                       tag=f"{tag}.kv{j}.flatten"))
    z = (z_groups[0] if len(z_groups) == 1
         else b.concat(z_groups, tag=f"{tag}.merge_heads"))
    wo = b.param(("blocks", "wo"), (A * hd, H), layer=l)
    return b.matmul(z, wo, tag=f"{tag}.attn.out")


def _decode_attention_batched(b: GraphBuilder, x: int, l: int, *, T: int,
                              H: int, A: int, KV: int, hd: int,
                              qkv_bias: bool, pos: int, pos_slots: list,
                              tag: str, B: int, window: bool = False) -> int:
    """B-slot cached attention over a merged (B, H) hidden state: merged
    B-row k/v/q projections, per-slot cache banks + masked attention
    streams, and a merged B-row output projection.  See _decode_attention.
    """
    g = A // KV
    z_parts: list = [[] for _ in range(B)]      # slot -> per-kv-head rows
    for j in range(KV):
        ck = (j * hd, (j + 1) * hd)
        bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                cols=ck), bias=bk, tag=f"{tag}.kv{j}.k")
        v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                cols=ck), bias=bv, tag=f"{tag}.kv{j}.v")
        banks = []
        for s in range(B):
            kc = b.cache(f"{tag}.kv{j}.slot{s}.k", (T, hd))
            vc = b.cache(f"{tag}.kv{j}.slot{s}.v", (T, hd))
            kc = b.cache_append(kc, k, pos, slot=s, window=window)
            vc = b.cache_append(vc, v, pos, slot=s, window=window)
            banks.append((kc, vc))
        q_heads = []
        for gi in range(g):
            i = j * g + gi
            cq = (i * hd, (i + 1) * hd)
            bq = (b.param(("blocks", "bq"), (hd,), layer=l, cols=cq)
                  if qkv_bias else None)
            q_heads.append(b.matmul(x, b.param(("blocks", "wq"), (H, hd), layer=l,
                                               cols=cq), bias=bq, tag=f"{tag}.h{i}.q"))
        for s in range(B):
            stag = f"{tag}.kv{j}.s{s}"
            rows = [b.slot_select(q, s, tag=f"{stag}.q{gi}")
                    for gi, q in enumerate(q_heads)]
            qg = (rows[0] if g == 1
                  else b.concat(rows, axis=-2, tag=f"{stag}.qstack"))
            kc, vc = banks[s]
            qk = b.matmul(qg, kc, transpose_b=True, scale=hd ** -0.5,
                          tag=f"{stag}.qk")
            sm = b.softmax(qk, valid_upto=pos_slots[s],
                           tag=f"{stag}.softmax")
            av = b.matmul(sm, vc, tag=f"{stag}.av")
            z_parts[s].append(av if g == 1
                              else b.reshape(av, (1, g * hd),
                                             tag=f"{stag}.flatten"))
    z_slots = [(parts[0] if len(parts) == 1
                else b.concat(parts, tag=f"{tag}.s{s}.merge_heads"))
               for s, parts in enumerate(z_parts)]
    z = b.concat(z_slots, axis=-2, tag=f"{tag}.merge_slots")
    wo = b.param(("blocks", "wo"), (A * hd, H), layer=l)
    return b.matmul(z, wo, tag=f"{tag}.attn.out")


def _logits_head(b: GraphBuilder, cfg: ModelConfig, x: int) -> int:
    """Final vocab projection: BERT reuses the (V, H) embedding table
    transposed (still MMU-resident)."""
    return b.matmul(x, b.param(("embed",), (cfg.vocab_size, cfg.d_model)),
                    transpose_b=True, tag="logits")


def _decode_inputs(b: GraphBuilder, batch: int):
    """The decode stream's pos input: a scalar for per-sequence streams, a
    (B,) vector (plus hoisted per-slot scalar selects for softmax masking)
    for batched streams."""
    if batch == 1:
        return b.input("pos", (), dtype="int32"), None
    pos = b.input("pos", (batch,), dtype="int32")
    return pos, [b.slot_select(pos, s, tag=f"pos.s{s}")
                 for s in range(batch)]


def _trace_decode_bert(cfg: ModelConfig, cache_len: int,
                       layers: Optional[int], include_embed: bool,
                       batch: int = 1, window: bool = False) -> Graph:
    """Causal incremental BERT step, mirroring models/bert.decode_step
    (post-norm blocks, learned positions gathered at `pos`)."""
    b = GraphBuilder()
    T, H, A, KV = cache_len, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    pos, pos_slots = _decode_inputs(b, batch)
    if include_embed:
        x = _embed(b, cfg, b.input("tokens", (batch,), dtype="int32"), pos, batch)
    else:
        x = b.input("x", (batch, H))
    for l in range(L):
        tag = f"enc{l}"
        proj = _decode_attention(b, x, l, T=T, H=H, A=A, KV=KV, hd=hd,
                                 qkv_bias=cfg.qkv_bias, pos=pos, tag=tag,
                                 B=batch, pos_slots=pos_slots, window=window)
        x = _post_norm_rest(b, x, proj, l, H=H, F=F, eps=1e-12,
                            mlp_bias=cfg.mlp_bias, norm_beta=True, tag=tag)
    if include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def trace_decode(cfg: ModelConfig, cache_len: int, *,
                 layers: Optional[int] = None,
                 include_embed: bool = True, batch: int = 1,
                 window: bool = False) -> Graph:
    """Emit the one-new-token decode graph for `cfg` over a KV cache of
    capacity `cache_len`.

    The graph takes a scalar int32 `pos` input (the current cache length):
    the new k/v append at slot `pos` and softmax masks slots > pos, so ONE
    compiled stream serves every step t < T.  Executed statefully by
    `repro_torch.npec.exec.DecodeSession`.

    batch=B > 1 emits the *batched* decode stream: B slots share one
    stream, weight projections merge into B-row MMU tiles, `pos` becomes a
    (B,) vector, and each slot keeps its own cache bank.

    window=True compiles the *ring* variant: cache banks of capacity
    `cache_len` whose appends wrap, so positions grow unbounded while the
    QK^T tile stays banded at `cache_len` keys (identical to the full model
    only while total tokens <= cache_len).
    """
    _require_bert(cfg, "decode")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if window and cfg.attention == "sliding" and cache_len != cfg.window:
        raise CompileError(
            f"windowed decode for {cfg.name!r} needs cache_len == "
            f"cfg.window ({cfg.window}), got {cache_len} — any other ring "
            "capacity diverges from the model's sliding-window mask")
    return _trace_decode_bert(cfg, cache_len, layers, include_embed, batch,
                              window)


def trace_prefill(cfg: ModelConfig, seq: int, *,
                  layers: Optional[int] = None,
                  include_embed: bool = True,
                  cache_len: Optional[int] = None,
                  window: bool = False) -> Graph:
    """Emit the *serving prefill* graph for a `seq`-token prompt: the causal
    BERT pass with the logits head (an incremental `models/bert.decode_step`
    rollout over the prompt, not the bidirectional encoder), whose
    per-kv-head (S, hd) k/v tensors are registered in `Graph.kv_exports`
    under the decode streams' canonical cache names, so one executed
    prefill seeds a decode slot's cache banks (`DecodeSession.load_slot`).

    cache_len=T switches to the *chunked* mode: one causal SLICE of `seq`
    prompt rows over the decode streams' (T, head_dim) cache banks — a
    (seq,) int32 `pos_ids` input carries each row's absolute position, the
    new k/v rows `cache_append` into the banks there, and a row-masked
    softmax over the updated cache gives row r the keys <= pos_ids[r].

    window=True serves a windowed engine: the prompt must fit cfg.window
    for "sliding"-attention configs.
    """
    if window and cfg.attention == "sliding" and seq > cfg.window:
        raise CompileError(
            f"windowed prefill for {cfg.name!r} holds at most cfg.window "
            f"({cfg.window}) prompt tokens, got {seq}")
    _require_bert(cfg, "serving prefill")
    if cache_len is not None:
        if seq > cache_len:
            raise ValueError(
                f"prefill slice of {seq} rows exceeds the cache capacity "
                f"{cache_len}")
        return _trace_prefill_chunk_bert(cfg, seq, cache_len, layers,
                                         include_embed)
    return _trace_bert(cfg, seq, layers, include_embed, causal=True,
                       logits_head=True, export_kv=True)


# ---------------------------------------------------------------------------
# Chunked-prefill slices: C prompt rows appended into decode cache banks
# ---------------------------------------------------------------------------

def _chunk_attention(b: GraphBuilder, x: int, l: int, *, T: int, H: int,
                     A: int, KV: int, hd: int, qkv_bias: bool, pos_ids: int,
                     tag: str) -> int:
    """Causal-slice attention for chunked prefill: C new prompt rows over
    the decode streams' (T, hd) cache banks; returns the output projection.

    Per kv head: the slice's (C, hd) k/v projections burst-append into the
    cache bank at their absolute positions `pos_ids`, then each query head
    runs a (C, T) QK^T over the *updated* bank with a row-masked softmax
    (row r attends to slots <= pos_ids[r]) and the AV reduction.
    """
    g = A // KV
    z_heads = []
    for j in range(KV):
        ck = (j * hd, (j + 1) * hd)
        bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                cols=ck), bias=bk, tag=f"{tag}.kv{j}.k")
        v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                cols=ck), bias=bv, tag=f"{tag}.kv{j}.v")
        kc = b.cache(f"{tag}.kv{j}.k", (T, hd))
        vc = b.cache(f"{tag}.kv{j}.v", (T, hd))
        kc = b.cache_append(kc, k, pos_ids)
        vc = b.cache_append(vc, v, pos_ids)
        for gi in range(g):
            i = j * g + gi
            cq = (i * hd, (i + 1) * hd)
            bq = (b.param(("blocks", "bq"), (hd,), layer=l, cols=cq)
                  if qkv_bias else None)
            q = b.matmul(x, b.param(("blocks", "wq"), (H, hd), layer=l,
                                    cols=cq), bias=bq, tag=f"{tag}.h{i}.q")
            qk = b.matmul(q, kc, transpose_b=True, scale=hd ** -0.5,
                          tag=f"{tag}.h{i}.qk")
            sm = b.softmax(qk, valid_upto=pos_ids,
                           tag=f"{tag}.h{i}.softmax")
            z_heads.append(b.matmul(sm, vc, tag=f"{tag}.h{i}.av"))
    z = b.concat(z_heads, tag=f"{tag}.merge_heads")
    wo = b.param(("blocks", "wo"), (A * hd, H), layer=l)
    return b.matmul(z, wo, tag=f"{tag}.attn.out")


def _trace_prefill_chunk_bert(cfg: ModelConfig, rows: int, cache_len: int,
                              layers: Optional[int],
                              include_embed: bool) -> Graph:
    """One causal BERT prefill slice of `rows` prompt tokens over
    cache banks of capacity `cache_len` (learned positions gathered at
    `pos_ids`, exactly as the decode step gathers at `pos`)."""
    b = GraphBuilder()
    C, T = rows, cache_len
    H, A, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    pos_ids = b.input("pos_ids", (C,), dtype="int32")
    if include_embed:
        x = _embed(b, cfg, b.input("tokens", (C,), dtype="int32"), pos_ids, C)
    else:
        x = b.input("x", (C, H))
    for l in range(L):
        tag = f"enc{l}"
        proj = _chunk_attention(b, x, l, T=T, H=H, A=A, KV=KV, hd=hd,
                                qkv_bias=cfg.qkv_bias, pos_ids=pos_ids,
                                tag=tag)
        x = _post_norm_rest(b, x, proj, l, H=H, F=F, eps=1e-12,
                            mlp_bias=cfg.mlp_bias, norm_beta=True, tag=tag)
    if include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def trace_prefill_slice_shape(shape, cache_len: int, rows: int, *,
                              layers: int = 1) -> Graph:
    """Headless chunked-prefill slice graph from dims alone (see
    trace_bert_shape): no biases, no embedding or logits head."""
    b = GraphBuilder()
    pos_ids = b.input("pos_ids", (rows,), dtype="int32")
    x = b.input("x", (rows, shape.hidden))
    for l in range(layers):
        tag = f"enc{l}"
        proj = _chunk_attention(b, x, l, T=cache_len, H=shape.hidden,
                                A=shape.heads, KV=shape.heads,
                                hd=shape.head_dim, qkv_bias=False,
                                pos_ids=pos_ids, tag=tag)
        x = _post_norm_rest(b, x, proj, l, H=shape.hidden, F=shape.d_ff,
                            eps=1e-12, mlp_bias=False, norm_beta=False,
                            tag=tag)
    b.output(x)
    return b.g


def trace_decode_bert_shape(shape, cache_len: int, *, layers: int = 1,
                            batch: int = 1, window: bool = False) -> Graph:
    """Headless decode-step graph from dims alone (see trace_bert_shape);
    batch=B emits the merged B-slot stream."""
    b = GraphBuilder()
    pos, pos_slots = _decode_inputs(b, batch)
    x = b.input("x", (batch, shape.hidden))
    for l in range(layers):
        tag = f"enc{l}"
        proj = _decode_attention(b, x, l, T=cache_len, H=shape.hidden,
                                 A=shape.heads, KV=shape.heads,
                                 hd=shape.head_dim, qkv_bias=False,
                                 pos=pos, tag=tag, B=batch,
                                 pos_slots=pos_slots, window=window)
        x = _post_norm_rest(b, x, proj, l, H=shape.hidden, F=shape.d_ff,
                            eps=1e-12, mlp_bias=False, norm_beta=False,
                            tag=tag)
    b.output(x)
    return b.g


# ---------------------------------------------------------------------------
# CLI: trace + compile + schedule, and with --check the compiled encoder
# against the hand-built program and the executor against the port's BERT
# ---------------------------------------------------------------------------

CHECK_TOL = 1e-2        # the reference's gate for its executor vs its model
HAND_TOL = 0.01         # compiled cycles/encoder vs the hand-built program


def _check_hand(cfg: ModelConfig, args, total_cycles: float) -> bool:
    """The compiled encoder's whole-op cycles per layer against
    `core.cycles.build_encoder_program` at the same dims: within 1%."""
    from repro_torch.core import cycles as cy
    from repro_torch.core.overlay import NPEHardware

    hand = cy.schedule(cy.build_encoder_program(
        NPEHardware(vrwidth=args.vrwidth),
        cy.BertShape(seq=args.seq, hidden=cfg.d_model, heads=cfg.num_heads,
                     d_ff=cfg.d_ff, encoders=cfg.num_layers), args.bits))
    per_enc = total_cycles / cfg.num_layers
    dev = abs(per_enc - hand["total_cycles"]) / hand["total_cycles"]
    print(f"compiled {per_enc:.0f} cycles/encoder vs hand-built "
          f"{hand['total_cycles']:.0f} ({100 * dev:.2f}% deviation, gate "
          f"{100 * HAND_TOL:g}%; overlay model cycles)")
    return dev < HAND_TOL


def _check(args, device) -> bool:
    """The compiled encoder stream through the executor against the port's
    `models/bert.encode` on the same random weights and 2 x seq tokens:
    float at the configuration's depth, NPE-8 and NPE-16 at 2 layers (the
    depth at which the reference gates its executor), each within 1e-2.
    With --decode T, also a T-step decode rollout against the serving
    prefill's logits at every position, in float."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.models import bert as bert_mod
    from repro_torch.models.bert import Bert
    from repro_torch.models.convert import param_tree_from_model
    from repro_torch.npec import (DecodeSession, compile_decode, compile_model,
                                  compile_prefill, execute)

    hw = NPEHardware(vrwidth=args.vrwidth)
    base = dataclasses.replace(get_config(args.model), dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    model = Bert(base, device=device).init(gen)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab_size, (2, args.seq), dtype=np.int64)).to(device)
    ok = True
    for mode, bits, layers in (("float", None, base.num_layers),
                               ("npe-8", 8, 2), ("npe-16", 16, 2)):
        cfg = dataclasses.replace(base, num_layers=layers)
        if bits:
            cfg = cfg.with_npe(quant_bits=bits)
        sub = Bert(cfg, device=device)
        sub.load_state_dict(model.state_dict(), strict=False)
        compiled = compile_model(cfg, args.seq, hw, bits=bits or 16)
        got = execute(compiled, param_tree_from_model(sub), {"tokens": tokens},
                      cfg=cfg, device=device)[0]
        want = bert_mod.encode(cfg, sub, tokens)
        err = float((got - want).abs().max())
        ok &= err <= CHECK_TOL
        print(f"executor vs models/bert.encode, {mode}, {layers} layers, "
              f"2 x {args.seq} tokens: max|err| = {err:.2e} (gate {CHECK_TOL:g})")
    if args.decode:
        cfg = dataclasses.replace(base, num_layers=2)
        sub = Bert(cfg, device=device)
        sub.load_state_dict(model.state_dict(), strict=False)
        params = param_tree_from_model(sub)
        T = args.decode
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, base.vocab_size, T, dtype=np.int64)).to(device)
        want = execute(compile_prefill(cfg, T, hw), params, {"tokens": toks},
                       cfg=cfg, device=device)[0]
        sess = DecodeSession(compile_decode(cfg, T, hw), params, cfg=cfg,
                             device=device)
        err = max(float((sess.step(toks[t:t + 1][None])[0, 0] - want[t]).abs().max())
                  for t in range(T))
        ok &= err <= CHECK_TOL
        print(f"decode stream ({T} steps) vs the serving prefill's logits, float, "
              f"2 layers: max|err| = {err:.2e} (gate {CHECK_TOL:g})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_base")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--vrwidth", type=int, default=1024)
    ap.add_argument("--decode", type=int, default=0, metavar="T",
                    help="compile a one-token decode step over a KV cache "
                         "of capacity T instead of a prefill stream")
    ap.add_argument("--check", action="store_true",
                    help="run the compiled stream through the executor and "
                         "hold it against the port's models/bert")
    ap.add_argument("--device", default="cuda",
                    help="where --check runs (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.npec import (compile_decode, compile_model, greedy_schedule,
                                  stream_schedule)

    cfg = get_config(args.model)
    hw = NPEHardware(vrwidth=args.vrwidth)
    if args.decode:
        compiled = compile_decode(cfg, args.decode, hw, bits=args.bits,
                                  include_embed=False)
    else:
        compiled = compile_model(cfg, args.seq, hw, bits=args.bits,
                                 include_embed=False)
    stats = greedy_schedule(compiled)
    tile = stream_schedule(compiled)
    print(f"{args.model}: {compiled.graph!r}")
    print(f"lowered to {len(compiled.instrs)} instrs "
          f"{compiled.counts_by_unit()}; overlay model cycles (200 MHz FPGA): "
          f"{stats['total_cycles']:.0f} whole-op / "
          f"{tile['total_cycles']:.0f} tile-streaming "
          f"(MMU util {100 * tile['mmu_util']:.1f}%)")
    if args.decode:
        t = compiled.mmu_tiling_summary()
        print(f"skinny matmuls: {t['skinny_matmuls']} "
              f"(MMU row occupancy {100 * t['efficiency']:.2f}%)")
    if args.check:
        if not args.decode and not _check_hand(cfg, args, stats["total_cycles"]):
            print("npec check FAILED: the compiled schedule deviates more than "
                  f"{100 * HAND_TOL:g}% from the hand-built program")
            return 1
        if not _check(args, args.device):
            print("npec check FAILED")
            return 1
        print("npec check OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

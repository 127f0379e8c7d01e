"""Tracers: registered model family -> npec graph IR (counterpart of
`repro/npec/trace.py`).

The tracer is the compiler's front end: it walks a `ModelConfig` and emits
the per-sequence dataflow graph (`repro_torch.npec.ir`) that lowering maps
onto the overlay.  Each family has an explicit emitter that mirrors the
port's model op for op, which is what makes the functional executor
(`repro_torch.npec.exec`) checkable against that model.  The emitters are
copies of the reference's, so both packages compile a configuration to the
same graph, node for node.

Families:
  * ``bert``   — post-norm encoder (paper Table 1), incl. GQA smoke shapes
                 (`models/bert.py`).
  * ``dense``  — pre-norm decoder blocks (RoPE + GQA + gated/plain MLP,
                 RMSNorm or LayerNorm), full causal attention, or ring
                 caches for "sliding" attention in the windowed decode
                 stream (`models/transformer.py`).
  * ``moe``    — dense blocks whose FFN is a mixture of experts every
                 `interleave` layers (granite: every layer; llama4:
                 interleaved, with a shared expert): the router product,
                 softmax/sigmoid probabilities, top-k gates and ids
                 (renormalized for softmax routers with k > 1), the
                 capacity-bounded dispatch into (E, C, D) slot buffers
                 with C = max(1, int(S*k/E * cf)), per-expert gated-MLP
                 products and the gate-weighted combine, as
                 `models/moe.apply` computes them (prefill only: the
                 reference compiles no MoE decode stream).
The reference's feature gates hold here too: per-head qk-norm,
local:global attention, parallel blocks, logit soft caps and M-RoPE raise
`CompileError` (gemma3, command-r, qwen2-vl), as does a MoE decode stream.

Three modes, as in the reference:
  * prefill (`trace_model`) — the whole sequence at once, per-head
    QK^T/softmax/AV over (S, S) scores;
  * decode  (`trace_decode`) — ONE new token against a KV cache of
    capacity T: skinny (1, H) projections, cache-append of the new k/v,
    a (g, T) QK^T over the cache, a pos-masked softmax and the AV
    reduction; batch=B merges B serving slots into one stream, window=True
    makes every bank a ring;
  * serving prefill (`trace_prefill`) — causal, with the logits head and
    kv exports that seed a decode slot; cache_len=T traces one chunked
    slice over the decode streams' cache banks.

CLI (on the card unless --device cpu):
    PYTHONPATH=src python -m repro_torch.npec.trace --model bert_base [--seq N | --decode T] \\
        [--bits 8|16] [--check]
prints the graph, its instruction counts by unit and the greedy and
streaming schedules' totals, which are cycles of the FPGA overlay model
(200 MHz), not time on a GPU.  --check on bert_base holds the compiled
encoder's cycles within 1% of the hand-built program
(`core.cycles.build_encoder_program`), then runs the compiled stream through
the executor and holds it against the port's `models/bert`; on a dense or
moe config it holds the compiled prefill stream (and, for dense, a decode
rollout) against the port's `models/transformer` at 2 layers; it exits
non-zero past any gate.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.npec.ir import Graph, GraphBuilder


class CompileError(NotImplementedError):
    """A model (or model feature) the compiler cannot lower yet."""


# ---------------------------------------------------------------------------
# BERT (paper Table 1): post-norm encoder
# ---------------------------------------------------------------------------

def _attention(b: GraphBuilder, x: int, l: int, *, S: int, H: int, A: int,
               KV: int, hd: int, qkv_bias: bool, causal: bool,
               rope_theta: Optional[float], tag: str,
               export_kv: bool = False) -> int:
    """Per-head multi-head attention; returns the output-projection node.

    Heads are emitted in plain dataflow order (q,k,v,qk,softmax,av per
    head) — deferring the AV matmuls past the next head's projections is
    the *scheduler's* job, not the tracer's.

    export_kv=True (serving prefill, `trace_prefill`) registers each kv
    head's post-rope (S, hd) k and v nodes in `Graph.kv_exports` under the
    decode streams' canonical cache names, so a slot's cache banks can be
    seeded from one prefill pass.
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
        if rope_theta is not None:
            q = b.rope(q, theta=rope_theta, tag=f"{tag}.h{i}.q_rope")
        if j not in kv_nodes:
            bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
                  if qkv_bias else None)
            bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
                  if qkv_bias else None)
            k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                    cols=ck), bias=bk, tag=f"{tag}.h{i}.k")
            if rope_theta is not None:
                k = b.rope(k, theta=rope_theta, tag=f"{tag}.h{i}.k_rope")
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
    """GELU-class two-matmul MLP (bert / plain dense); returns the down
    projection (pre-residual)."""
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
                      qkv_bias=qkv_bias, causal=causal, rope_theta=None,
                      tag=tag, export_kv=export_kv)
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


# ---------------------------------------------------------------------------
# Dense decoder family (pre-norm GQA + gated/plain MLP)
# ---------------------------------------------------------------------------

def _check_block_supported(cfg: ModelConfig, *, moe_ok: bool = False,
                           window_ok: bool = False) -> None:
    """Feature gates shared by the dense and moe families, the reference's
    own: `moe_ok` lets the moe tracer accept the MoE config it exists to
    lower, `window_ok` lets the windowed decode tracers accept "sliding"
    attention (a ring cache of capacity cfg.window IS sliding-window
    attention — see `trace_decode(window=True)`)."""
    attn_gap = (cfg.attention != "full"
                and not (window_ok and cfg.attention == "sliding"))
    for feat, msg in (
            (cfg.moe is not None and not moe_ok, "MoE routing"),
            (attn_gap, f"{cfg.attention!r} attention streams"),
            (cfg.parallel_block, "parallel attn+mlp blocks"),
            (cfg.qk_norm, "per-head qk-norm"),
            (cfg.logit_softcap > 0, "logit softcapping"),
            (cfg.ssm is not None, "SSM recurrences"),
            (cfg.rope not in ("standard", "none"),
             f"{cfg.rope!r} positional encoding"),
    ):
        if feat:
            raise CompileError(
                f"npec cannot lower {msg} yet for {cfg.name!r} "
                "(see ROADMAP.md Open items)")


def _check_dense_supported(cfg: ModelConfig, *,
                           window_ok: bool = False) -> None:
    _check_block_supported(cfg, moe_ok=False, window_ok=window_ok)


def _rope_theta(cfg: ModelConfig) -> Optional[float]:
    return cfg.rope_theta if cfg.rope == "standard" else None


def _dense_embed(b: GraphBuilder, cfg: ModelConfig, rows: int,
                 include_embed: bool) -> int:
    """The token embedding of a decoder stream, or its hidden-state input."""
    if include_embed:
        tokens = b.input("tokens", (rows,), dtype="int32")
        return b.embed(tokens, b.param(("embed",), (cfg.vocab_size, cfg.d_model)),
                       tag="embed.tok")
    return b.input("x", (rows, cfg.d_model))


def _dense_head(b: GraphBuilder, cfg: ModelConfig, x: int,
                include_embed: bool) -> Graph:
    """The final norm, the logits head when the stream has its embedding,
    and the output."""
    x = _dense_norm(b, cfg, x, ("ln_f",), None, "ln_f")
    if include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def _trace_dense(cfg: ModelConfig, seq: int, layers: Optional[int],
                 include_embed: bool, *, export_kv: bool = False,
                 window_ok: bool = False) -> Graph:
    _check_dense_supported(cfg, window_ok=window_ok)
    b = GraphBuilder()
    S, H, A, KV = seq, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    x = _dense_embed(b, cfg, S, include_embed)
    for l in range(L):
        tag = f"blk{l}"
        h = _dense_norm(b, cfg, x, ("blocks", "ln1"), l, f"{tag}.ln1")
        attn = _attention(b, h, l, S=S, H=H, A=A, KV=KV, hd=hd,
                          qkv_bias=cfg.qkv_bias, causal=cfg.causal,
                          rope_theta=_rope_theta(cfg), tag=tag,
                          export_kv=export_kv)
        x = b.add(x, attn, tag=f"{tag}.res_a")
        h2 = _dense_norm(b, cfg, x, ("blocks", "ln2"), l, f"{tag}.ln2")
        down = _dense_mlp(b, cfg, h2, l, H=H, F=F, tag=tag)
        x = b.add(x, down, tag=f"{tag}.res_b")
    return _dense_head(b, cfg, x, include_embed)


def _dense_mlp(b: GraphBuilder, cfg: ModelConfig, h2: int, l: int, *,
               H: int, F: int, tag: str) -> int:
    """Gated (SwiGLU/GeGLU) or plain MLP for the dense family; returns the
    down projection (pre-residual)."""
    if cfg.mlp_type == "gated":
        gt = b.act(b.matmul(
            h2, b.param(("blocks", "mlp", "wg"), (H, F), layer=l),
            tag=f"{tag}.ffg"), cfg.activation, tag=f"{tag}.act")
        up = b.matmul(h2, b.param(("blocks", "mlp", "wu"), (H, F),
                                  layer=l), tag=f"{tag}.ffu")
        hmid = b.mul(gt, up, tag=f"{tag}.gate")
        return b.matmul(hmid, b.param(("blocks", "mlp", "wd"), (F, H),
                                      layer=l), tag=f"{tag}.ffd")
    return _plain_mlp(b, h2, l, H=H, F=F, mlp_bias=cfg.mlp_bias,
                      act=cfg.activation, tag=tag)


def _dense_norm(b: GraphBuilder, cfg: ModelConfig, x: int, path, layer,
                tag: str) -> int:
    """models/common.py::apply_norm at its default eps=1e-6, including the
    beta parameter when the config carries one."""
    H = cfg.d_model
    gamma = b.param(tuple(path) + ("gamma",), (H,), layer=layer)
    if cfg.norm == "layernorm":
        beta = (b.param(tuple(path) + ("beta",), (H,), layer=layer)
                if cfg.norm_bias else None)
        return b.layernorm(x, gamma, beta, eps=1e-6, tag=tag)
    return b.rmsnorm(x, gamma, eps=1e-6, tag=tag)


# ---------------------------------------------------------------------------
# MoE family (granite: every layer; llama4: every `interleave`-th layer)
# ---------------------------------------------------------------------------

def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Expert capacity C = max(1, int(S*k/E * capacity_factor)) — the
    per-sequence slot budget `models/moe.apply` dispatches into."""
    m = cfg.moe
    return max(1, int(seq * m.top_k / m.num_experts * m.capacity_factor))


def _moe_ffn(b: GraphBuilder, cfg: ModelConfig, x: int, mi: int, *, S: int,
             tag: str):
    """One MoE FFN block mirroring `models/moe.apply` op for op:
    router matmul (MMU) -> softmax/sigmoid probabilities (NVU) -> top-k
    gates + indices (renormalized for softmax routers with k > 1) ->
    capacity-bounded scatter into (E, C, D) slot buffers (MWU) -> E
    per-expert gated-MLP matmul streams over C-row tiles (skinny when
    C < 128 PE rows) -> gate-weighted combine gather (MRU) -> optional
    shared expert.  Router and expert matmuls are pinned to the float
    path (`quantize=False`): the model computes them as float products
    even in NPE mode; the shared expert routes through `common.dense` and
    stays quantizable.

    Returns (out_node, aux) where aux exposes the routing nodes
    (gates/ids/dispatch/combine) for conformance and property tests.
    """
    m = cfg.moe
    H, F, E, k = cfg.d_model, cfg.d_ff, m.num_experts, m.top_k
    cap = moe_capacity(cfg, S)
    router = b.param(("blocks", "moe", "router"), (H, E), layer=mi)
    logits = b.matmul(x, router, quantize=False, tag=f"{tag}.router")
    if m.router_act == "sigmoid":
        probs = b.act(logits, "sigmoid", tag=f"{tag}.router_probs")
    else:
        probs = b.softmax(logits, tag=f"{tag}.router_probs")
    renorm = m.router_act == "softmax" and k > 1
    gates, ids = b.topk(probs, k, renorm=renorm, tag=f"{tag}.topk")
    buf = b.scatter_slot(x, ids, num_experts=E, capacity=cap, top_k=k,
                         tag=f"{tag}.dispatch")
    outs = []
    for e in range(E):
        etag = f"{tag}.x{e}"
        xe = b.gather(buf, index=e, tag=f"{etag}.gather")
        wg = b.param(("blocks", "moe", "wg"), (H, F), layer=mi, index=e)
        wu = b.param(("blocks", "moe", "wu"), (H, F), layer=mi, index=e)
        wd = b.param(("blocks", "moe", "wd"), (F, H), layer=mi, index=e)
        gt = b.act(b.matmul(xe, wg, quantize=False, tag=f"{etag}.ffg"),
                   cfg.activation, tag=f"{etag}.act")
        up = b.matmul(xe, wu, quantize=False, tag=f"{etag}.ffu")
        h = b.mul(gt, up, tag=f"{etag}.gate")
        outs.append(b.matmul(h, wd, quantize=False, tag=f"{etag}.ffd"))
    stacked = (outs[0] if E == 1
               else b.concat(outs, axis=-2, tag=f"{tag}.expert_stack"))
    out = b.gather(stacked, expert_ids=ids, gates=gates, num_experts=E,
                   capacity=cap, top_k=k, tag=f"{tag}.combine")
    aux = dict(gates=gates, ids=ids, dispatch=buf, combine=out)
    if m.shared_expert:
        sg = b.act(b.matmul(x, b.param(("blocks", "moe", "shared", "wg"),
                                       (H, F), layer=mi),
                            tag=f"{tag}.shared.ffg"),
                   cfg.activation, tag=f"{tag}.shared.act")
        su = b.matmul(x, b.param(("blocks", "moe", "shared", "wu"), (H, F),
                                 layer=mi), tag=f"{tag}.shared.ffu")
        sh = b.mul(sg, su, tag=f"{tag}.shared.gate")
        sd = b.matmul(sh, b.param(("blocks", "moe", "shared", "wd"), (F, H),
                                  layer=mi), tag=f"{tag}.shared.ffd")
        out = b.add(out, sd, tag=f"{tag}.shared.res")
    return out, aux


def _trace_moe(cfg: ModelConfig, seq: int, layers: Optional[int],
               include_embed: bool) -> Graph:
    """Pre-norm decoder stack whose FFN is MoE on every `interleave`-th
    layer (`models/transformer.layer_is_moe`: layer l is MoE iff
    (l+1) % interleave == 0) and a dense MLP otherwise — mirroring
    `models/transformer.apply` for family "moe"."""
    _check_block_supported(cfg, moe_ok=True)
    b = GraphBuilder()
    S, H, A, KV = seq, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    step = cfg.moe.interleave
    x = _dense_embed(b, cfg, S, include_embed)
    mi = di = 0                      # moe / dense-mlp stacked-param indices
    for l in range(L):
        tag = f"blk{l}"
        h = _dense_norm(b, cfg, x, ("blocks", "ln1"), l, f"{tag}.ln1")
        attn = _attention(b, h, l, S=S, H=H, A=A, KV=KV, hd=hd,
                          qkv_bias=cfg.qkv_bias, causal=cfg.causal,
                          rope_theta=_rope_theta(cfg), tag=tag)
        x = b.add(x, attn, tag=f"{tag}.res_a")
        h2 = _dense_norm(b, cfg, x, ("blocks", "ln2"), l, f"{tag}.ln2")
        if (l + 1) % step == 0:
            down, _ = _moe_ffn(b, cfg, h2, mi, S=S, tag=tag)
            mi += 1
        else:
            down = _dense_mlp(b, cfg, h2, di, H=H, F=F, tag=tag)
            di += 1
        x = b.add(x, down, tag=f"{tag}.res_b")
    return _dense_head(b, cfg, x, include_embed)


def trace_moe_block(cfg: ModelConfig, seq: int, *, layer: int = 0,
                    debug_outputs: bool = False) -> Graph:
    """Graph of ONE MoE FFN block over an (S, D) hidden-state input — the
    isolated unit the dispatch tests hold against `models/moe.apply` (feed
    params under {"blocks": {"moe": ...}}).  debug_outputs=True also marks
    the routing intermediates (gates, indices, dispatch buffer) as graph
    outputs."""
    b = GraphBuilder()
    x = b.input("x", (seq, cfg.d_model))
    out, aux = _moe_ffn(b, cfg, x, layer, S=seq, tag=f"moe{layer}")
    b.output(out)
    if debug_outputs:
        b.output(aux["gates"])
        b.output(aux["ids"])
        b.output(aux["dispatch"])
    return b.g


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

_TRACERS = {"bert": _trace_bert, "dense": _trace_dense, "moe": _trace_moe}


def trace_model(cfg: ModelConfig, seq: int, *, layers: Optional[int] = None,
                include_embed: bool = True) -> Graph:
    """Emit the IR graph for `cfg` at sequence length `seq`.

    layers=N truncates the stack (cycle models usually compile one layer
    and scale); include_embed=False starts from a hidden-state input.
    """
    tracer = _TRACERS.get(cfg.family)
    if tracer is None:
        raise CompileError(
            f"npec has no tracer for family {cfg.family!r} ({cfg.name!r}) "
            "yet (see ROADMAP.md Open items)")
    return tracer(cfg, seq, layers, include_embed)


def trace_bert_shape(shape, *, layers: int = 1) -> Graph:
    """Encoder-only graph from dims alone: any object with the attributes
    `seq`, `hidden`, `heads`, `head_dim` and `d_ff` (`core.cycles.BertShape`).
    No biases: bias adds are folded and cost nothing, so the instruction
    stream is cycle-identical either way."""
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
                      A: int, KV: int, hd: int, qkv_bias: bool,
                      rope_theta: Optional[float], pos: int,
                      tag: str, B: int = 1,
                      pos_slots: Optional[list] = None,
                      window: bool = False) -> int:
    """Cached one-token attention; returns the output-projection node.

    Per kv head: the new k/v appended into the (T, hd) cache at `pos`
    (MWU traffic, folded), the group's skinny (1, H) q projections stacked
    into (g, hd), a (g, T) QK^T over the cache, a pos-masked softmax, and
    the attention-weighted V reduction.  RoPE rotates the new k and the
    queries at `pos`.

    B > 1 is the *batched* decode stream: B serving slots share one stream,
    so every weight projection is a single merged B-row MMU tile over the
    stacked slot states, `pos` is a (B,) vector (rope rotates row s at
    pos[s]), and each slot keeps its own cache bank
    (`{tag}.kv{j}.slot{s}.k/v`) with its own pos-masked QK^T/softmax/AV
    stream.  `pos_slots[s]` is the hoisted scalar slot_select of pos for
    softmax masking.

    window=True makes every cache bank a ring: the append wraps at T and
    the pos-masked softmax saturates to the full T-slot ring once pos >= T.
    """
    g = A // KV
    if B > 1:
        return _decode_attention_batched(
            b, x, l, T=T, H=H, A=A, KV=KV, hd=hd, qkv_bias=qkv_bias,
            rope_theta=rope_theta, pos=pos, pos_slots=pos_slots, tag=tag,
            B=B, window=window)
    z_groups = []
    for j in range(KV):
        ck = (j * hd, (j + 1) * hd)
        bk = (b.param(("blocks", "bk"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        bv = (b.param(("blocks", "bv"), (hd,), layer=l, cols=ck)
              if qkv_bias else None)
        k = b.matmul(x, b.param(("blocks", "wk"), (H, hd), layer=l,
                                cols=ck), bias=bk, tag=f"{tag}.kv{j}.k")
        if rope_theta is not None:
            k = b.rope(k, theta=rope_theta, pos=pos,
                       tag=f"{tag}.kv{j}.k_rope")
        v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                cols=ck), bias=bv, tag=f"{tag}.kv{j}.v")
        kc = b.cache(f"{tag}.kv{j}.k", (T, hd))
        vc = b.cache(f"{tag}.kv{j}.v", (T, hd))
        kc = b.cache_append(kc, k, pos, window=window)
        vc = b.cache_append(vc, v, pos, window=window)
        q_heads = _q_heads(b, x, l, j, g=g, H=H, hd=hd, qkv_bias=qkv_bias,
                           rope_theta=rope_theta, pos=pos, tag=tag)
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


def _q_heads(b: GraphBuilder, x: int, l: int, j: int, *, g: int, H: int,
             hd: int, qkv_bias: bool, rope_theta: Optional[float], pos: int,
             tag: str) -> list:
    """The q projections of kv head j's g query heads, rotated at `pos`."""
    q_heads = []
    for gi in range(g):
        i = j * g + gi
        cq = (i * hd, (i + 1) * hd)
        bq = (b.param(("blocks", "bq"), (hd,), layer=l, cols=cq)
              if qkv_bias else None)
        q = b.matmul(x, b.param(("blocks", "wq"), (H, hd), layer=l,
                                cols=cq), bias=bq, tag=f"{tag}.h{i}.q")
        if rope_theta is not None:
            q = b.rope(q, theta=rope_theta, pos=pos,
                       tag=f"{tag}.h{i}.q_rope")
        q_heads.append(q)
    return q_heads


def _decode_attention_batched(b: GraphBuilder, x: int, l: int, *, T: int,
                              H: int, A: int, KV: int, hd: int,
                              qkv_bias: bool, rope_theta: Optional[float],
                              pos: int, pos_slots: list, tag: str,
                              B: int, window: bool = False) -> int:
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
        if rope_theta is not None:
            k = b.rope(k, theta=rope_theta, pos=pos,
                       tag=f"{tag}.kv{j}.k_rope")
        v = b.matmul(x, b.param(("blocks", "wv"), (H, hd), layer=l,
                                cols=ck), bias=bv, tag=f"{tag}.kv{j}.v")
        banks = []
        for s in range(B):
            kc = b.cache(f"{tag}.kv{j}.slot{s}.k", (T, hd))
            vc = b.cache(f"{tag}.kv{j}.slot{s}.v", (T, hd))
            kc = b.cache_append(kc, k, pos, slot=s, window=window)
            vc = b.cache_append(vc, v, pos, slot=s, window=window)
            banks.append((kc, vc))
        q_heads = _q_heads(b, x, l, j, g=g, H=H, hd=hd, qkv_bias=qkv_bias,
                           rope_theta=rope_theta, pos=pos, tag=tag)
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
    """Final vocab projection: tied configs (and BERT) reuse the (V, H)
    embedding table transposed (still MMU-resident), untied ones use
    lm_head (H, V)."""
    V, H = cfg.vocab_size, cfg.d_model
    if cfg.tie_embeddings or cfg.family == "bert":
        return b.matmul(x, b.param(("embed",), (V, H)), transpose_b=True,
                        tag="logits")
    return b.matmul(x, b.param(("lm_head",), (H, V)), tag="logits")


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
                                 qkv_bias=cfg.qkv_bias, rope_theta=None,
                                 pos=pos, tag=tag, B=batch,
                                 pos_slots=pos_slots, window=window)
        x = _post_norm_rest(b, x, proj, l, H=H, F=F, eps=1e-12,
                            mlp_bias=cfg.mlp_bias, norm_beta=True, tag=tag)
    if include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def _trace_decode_dense(cfg: ModelConfig, cache_len: int,
                        layers: Optional[int], include_embed: bool,
                        batch: int = 1, window: bool = False) -> Graph:
    """Pre-norm dense decode step, mirroring models/transformer.decode_step
    (full-attention layers, or ring caches for "sliding" attention when
    window=True — see trace_decode)."""
    _check_dense_supported(cfg, window_ok=window)
    b = GraphBuilder()
    T, H, A, KV = cache_len, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    pos, pos_slots = _decode_inputs(b, batch)
    x = _dense_embed(b, cfg, batch, include_embed)
    for l in range(L):
        tag = f"blk{l}"
        h = _dense_norm(b, cfg, x, ("blocks", "ln1"), l, f"{tag}.ln1")
        attn = _decode_attention(b, h, l, T=T, H=H, A=A, KV=KV, hd=hd,
                                 qkv_bias=cfg.qkv_bias,
                                 rope_theta=_rope_theta(cfg), pos=pos,
                                 tag=tag, B=batch, pos_slots=pos_slots,
                                 window=window)
        x = b.add(x, attn, tag=f"{tag}.res_a")
        h2 = _dense_norm(b, cfg, x, ("blocks", "ln2"), l, f"{tag}.ln2")
        down = _dense_mlp(b, cfg, h2, l, H=H, F=F, tag=tag)
        x = b.add(x, down, tag=f"{tag}.res_b")
    return _dense_head(b, cfg, x, include_embed)


_DECODE_TRACERS = {"bert": _trace_decode_bert, "dense": _trace_decode_dense}


def _no_decode(cfg: ModelConfig) -> str:
    """What the compiler lacks to serve `cfg`'s family."""
    gap = ("MoE decode streams (per-token capacity-1 dispatch)"
           if cfg.family == "moe"
           else f"decode streams for family {cfg.family!r}")
    return f"npec cannot lower {gap} yet ({cfg.name!r})"


def trace_decode(cfg: ModelConfig, cache_len: int, *,
                 layers: Optional[int] = None,
                 include_embed: bool = True, batch: int = 1,
                 window: bool = False) -> Graph:
    """Emit the one-new-token decode graph for `cfg` over a KV cache of
    capacity `cache_len`.

    The graph takes a scalar int32 `pos` input (the current cache length):
    the new k/v append at slot `pos`, softmax masks slots > pos, and RoPE
    rotates at `pos`, so ONE compiled stream serves every step t < T.
    Executed statefully by `repro_torch.npec.exec.DecodeSession`.

    batch=B > 1 emits the *batched* decode stream: B slots share one
    stream, weight projections merge into B-row MMU tiles, `pos` becomes a
    (B,) vector, and each slot keeps its own cache bank.

    window=True compiles the *ring* variant: cache banks of capacity
    `cache_len` whose appends wrap, so positions grow unbounded while the
    QK^T tile stays banded at `cache_len` keys.  For "sliding"-attention
    configs (starcoder2) `cache_len` must equal `cfg.window`: the ring then
    matches `models/transformer.decode_step`'s window caches at every
    position.  Full-attention configs may also trace windowed (identical to
    the full model only while total tokens <= cache_len).  The moe family
    has no decode stream and raises `CompileError`, as in the reference.
    """
    tracer = _DECODE_TRACERS.get(cfg.family)
    if tracer is None:
        raise CompileError(f"{_no_decode(cfg)} (see ROADMAP.md Open items)")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if window and cfg.attention == "sliding" and cache_len != cfg.window:
        raise CompileError(
            f"windowed decode for {cfg.name!r} needs cache_len == "
            f"cfg.window ({cfg.window}), got {cache_len} — any other ring "
            "capacity diverges from the model's sliding-window mask")
    return tracer(cfg, cache_len, layers, include_embed, batch, window)


def _require_causal(cfg: ModelConfig) -> None:
    if not cfg.causal:
        raise CompileError(
            f"npec serving prefill needs a causal model; {cfg.name!r} "
            "is bidirectional")


def trace_prefill(cfg: ModelConfig, seq: int, *,
                  layers: Optional[int] = None,
                  include_embed: bool = True,
                  cache_len: Optional[int] = None,
                  window: bool = False) -> Graph:
    """Emit the *serving prefill* graph for a `seq`-token prompt: a causal
    prefill pass whose per-kv-head post-rope (S, hd) k/v tensors are
    registered in `Graph.kv_exports` under the decode streams' canonical
    cache names, so one executed prefill seeds a decode slot's cache banks
    (`DecodeSession.load_slot`).

    bert traces its *causal* serving variant with the logits head (an
    incremental `models/bert.decode_step` rollout over the prompt, not the
    bidirectional encoder); dense traces its ordinary causal prefill.
    Families without decode streams (moe) raise `CompileError`: a serving
    engine needs both halves.

    cache_len=T switches to the *chunked* mode: one causal SLICE of `seq`
    prompt rows over the decode streams' (T, head_dim) cache banks — a
    (seq,) int32 `pos_ids` input carries each row's absolute position (and
    RoPE angle), the new k/v rows `cache_append` into the banks there, and
    a row-masked softmax over the updated cache gives row r the keys <=
    pos_ids[r].

    window=True serves a windowed engine (ring decode banks of capacity
    cfg.window): the prompt must fit the window, which also lifts the
    "sliding"-attention gate for those configs.
    """
    if window and cfg.attention == "sliding" and seq > cfg.window:
        raise CompileError(
            f"windowed prefill for {cfg.name!r} holds at most cfg.window "
            f"({cfg.window}) prompt tokens, got {seq} — longer prompts "
            "need banded prefill tiles (see ROADMAP.md Open items)")
    if cache_len is not None:
        if seq > cache_len:
            raise ValueError(
                f"prefill slice of {seq} rows exceeds the cache capacity "
                f"{cache_len}")
        if cfg.family == "bert":
            return _trace_prefill_chunk_bert(cfg, seq, cache_len, layers,
                                             include_embed)
        if cfg.family == "dense":
            _require_causal(cfg)
            return _trace_prefill_chunk_dense(cfg, seq, cache_len, layers,
                                              include_embed,
                                              window_ok=window)
    elif cfg.family == "bert":
        return _trace_bert(cfg, seq, layers, include_embed, causal=True,
                           logits_head=True, export_kv=True)
    elif cfg.family == "dense":
        _require_causal(cfg)
        return _trace_dense(cfg, seq, layers, include_embed, export_kv=True,
                            window_ok=window)
    raise CompileError(
        f"{_no_decode(cfg)}, so it cannot serve this family "
        "(see ROADMAP.md Open items)")


# ---------------------------------------------------------------------------
# Chunked-prefill slices: C prompt rows appended into decode cache banks
# ---------------------------------------------------------------------------

def _chunk_attention(b: GraphBuilder, x: int, l: int, *, T: int, H: int,
                     A: int, KV: int, hd: int, qkv_bias: bool,
                     rope_theta: Optional[float], pos_ids: int,
                     tag: str) -> int:
    """Causal-slice attention for chunked prefill: C new prompt rows over
    the decode streams' (T, hd) cache banks; returns the output projection.

    Per kv head: the slice's (C, hd) k/v projections (post-rope at their
    absolute positions `pos_ids`) burst-append into the cache bank, then
    each query head runs a (C, T) QK^T over the *updated* bank with a
    row-masked softmax (row r attends to slots <= pos_ids[r]) and the AV
    reduction.
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
        if rope_theta is not None:
            k = b.rope(k, theta=rope_theta, pos=pos_ids,
                       tag=f"{tag}.kv{j}.k_rope")
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
            if rope_theta is not None:
                q = b.rope(q, theta=rope_theta, pos=pos_ids,
                           tag=f"{tag}.h{i}.q_rope")
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
                                qkv_bias=cfg.qkv_bias, rope_theta=None,
                                pos_ids=pos_ids, tag=tag)
        x = _post_norm_rest(b, x, proj, l, H=H, F=F, eps=1e-12,
                            mlp_bias=cfg.mlp_bias, norm_beta=True, tag=tag)
    if include_embed:
        x = _logits_head(b, cfg, x)
    b.output(x)
    return b.g


def _trace_prefill_chunk_dense(cfg: ModelConfig, rows: int, cache_len: int,
                               layers: Optional[int],
                               include_embed: bool, *,
                               window_ok: bool = False) -> Graph:
    """One causal dense prefill slice of `rows` prompt tokens over cache
    banks of capacity `cache_len` (RoPE rotated at `pos_ids`)."""
    _check_dense_supported(cfg, window_ok=window_ok)
    b = GraphBuilder()
    C, T = rows, cache_len
    H, A, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.head_dim, cfg.d_ff
    L = layers if layers is not None else cfg.num_layers
    pos_ids = b.input("pos_ids", (C,), dtype="int32")
    x = _dense_embed(b, cfg, C, include_embed)
    for l in range(L):
        tag = f"blk{l}"
        h = _dense_norm(b, cfg, x, ("blocks", "ln1"), l, f"{tag}.ln1")
        attn = _chunk_attention(b, h, l, T=T, H=H, A=A, KV=KV, hd=hd,
                                qkv_bias=cfg.qkv_bias,
                                rope_theta=_rope_theta(cfg),
                                pos_ids=pos_ids, tag=tag)
        x = b.add(x, attn, tag=f"{tag}.res_a")
        h2 = _dense_norm(b, cfg, x, ("blocks", "ln2"), l, f"{tag}.ln2")
        down = _dense_mlp(b, cfg, h2, l, H=H, F=F, tag=tag)
        x = b.add(x, down, tag=f"{tag}.res_b")
    return _dense_head(b, cfg, x, include_embed)


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
                                rope_theta=None, pos_ids=pos_ids, tag=tag)
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
                                 rope_theta=None, pos=pos, tag=tag,
                                 B=batch, pos_slots=pos_slots,
                                 window=window)
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


def _nudged(model):
    """A copy of `model` with every weight moved up by one float32 ulp."""
    import copy

    import torch

    other = copy.deepcopy(model)
    with torch.no_grad():
        for p in other.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    return other


def _check_decoder(args, device) -> bool:
    """A dense or moe configuration at full width cut to 2 layers, float32,
    random weights: the compiled prefill stream through the executor against
    the port's `models/transformer.apply` on the same weights on the same
    device (its attention the plain version, which takes float32 k and v on
    the card) on 2 x seq tokens, in float, NPE-8 and NPE-16.  A MoE model
    takes the executor's expert ids
    (`models/moe.ForcedRouting`): the two sum router products in other
    orders, and a routing choice can turn on the last bit of a probability;
    where the model's own top-k differs, the count and the largest
    probability gap are printed.  Float within CHECK_TOL; an NPE mode within
    CHECK_TOL or, past it, twice the model's own change under a 1-ulp
    weight nudge (an int8 step can flip with an ulp).  For a dense
    configuration also a `--decode T` (default 8) step rollout in float
    against the serving prefill's logits at every position."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.convert import param_tree_from_model
    from repro_torch.models.moe import ForcedRouting
    from repro_torch.npec import (DecodeSession, compile_decode, compile_model,
                                  compile_prefill, execute)

    hw = NPEHardware(vrwidth=args.vrwidth)
    cfg = dataclasses.replace(get_config(args.model), num_layers=2, dtype="float32")
    model = registry.build_model(cfg, device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
    nudged = _nudged(model)
    params = param_tree_from_model(model)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, args.seq), dtype=np.int64)).to(device)
    ok = True
    for mode, bits in (("float", None), ("npe-8", 8), ("npe-16", 16)):
        c = cfg.with_npe(quant_bits=bits) if bits else cfg
        compiled = compile_model(c, args.seq, hw, bits=bits or 16)
        g = compiled.graph
        g.outputs.extend(n.id for n in g.nodes              # each MoE layer's expert ids
                         if n.op == "topk" and n.attrs["out"] == "indices")
        res = execute(compiled, params, {"tokens": tokens}, cfg=c, device=device)
        got, ids = res.outputs[0], res.outputs[1:]
        with ForcedRouting(ids) as fr, ops.plain_dense_attention():
            want = registry.apply(c, model, tokens)
        err = float((got - want).abs().max())
        gate = CHECK_TOL
        if bits and err > gate:
            with ForcedRouting(ids), ops.plain_dense_attention():
                noise = float((registry.apply(c, nudged, tokens) - want).abs().max())
            gate = max(gate, 2 * noise)
        ok &= err <= gate
        routing = ""
        if cfg.family == "moe":
            ok &= len(fr.calls) == len(ids) > 0
            routing = (f"; the model's own top-k differs at {fr.differ} of "
                       f"{ids[0].numel() * len(ids)} choices (largest probability gap "
                       f"{fr.gap:.2e})")
        print(f"executor vs models/transformer.apply, {mode}, 2 layers, 2 x {args.seq} "
              f"tokens on {device}: max|err| = {err:.2e} (gate {gate:.2e}){routing}")
    if cfg.family == "dense":
        T = args.decode or 8
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, T, dtype=np.int64)).to(device)
        want = execute(compile_prefill(cfg, T, hw), params, {"tokens": toks},
                       cfg=cfg, device=device)[0]
        sess = DecodeSession(compile_decode(cfg, T, hw), params, cfg=cfg, device=device)
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
                         "hold it against the port's model")
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
        if cfg.family != "bert":
            if not _check_decoder(args, args.device):
                print("npec check FAILED")
                return 1
            print("npec check OK")
            return 0
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

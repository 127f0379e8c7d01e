"""Graph IR for the NPE compiler (npec).

A copy of `repro/npec/ir.py` in the port, which imports nothing of the
reference package.

A `Graph` is a flat, topologically-ordered list of `Node`s — the unit of
exchange between the tracers (repro.npec.trace), the lowering passes
(repro.npec.lower) and the functional executor (repro.npec.exec).  Shapes
are per-sequence (no batch dimension): the overlay processes one sequence
at a time (paper §5.1), and the executor re-vectorizes over a leading
batch axis for free.

Op set
------
Compute ops (lowered to MMU / NVU instructions):
  * ``matmul``     inputs (a, b[, bias]); attrs transpose_b, scale.
                   When b is a ``param`` node the weight is MMU-resident
                   (quantizable); activation x activation matmuls (QK^T,
                   AV) stay in the MMU's activation path.
  * ``softmax``    inputs (x,); attrs causal (bool mask over last 2 dims).
  * ``layernorm``  inputs (x, gamma[, beta]); attrs eps.
  * ``rmsnorm``    inputs (x, gamma); attrs eps.
  * ``act``        inputs (x,); attrs fn ("gelu" | "silu" | "tanh" | ...).
  * ``rope``       inputs (x,); attrs theta (rotary embedding, NVU vector
                   arithmetic — costed as an elementwise PWL-class stream).

Structural ops (folded by lowering — MRU/MWU traffic or MMU/NVU stream
epilogues, never a compute instruction of their own):
  * ``input``      graph input placeholder; attrs name.
  * ``param``      parameter leaf; attrs path (tuple of tree keys), layer
                   (stacked-layer index or None), rows / cols (half-open
                   slice tuples or None), index (single leading row).
  * ``add`` / ``mul``   elementwise (residuals, gated-MLP gating).
  * ``concat``     attrs axis (head merge).
  * ``reshape``    pure layout change (decode streams flatten a GQA
                   group's (g, head_dim) attention output into the (1,
                   g*head_dim) row the output projection consumes).
  * ``embed``      inputs (tokens, table) — MRU gather.

Cache-resident tensors (decode streams, paper's autoregressive serving):
  * ``cache``         a persistent KV-cache tensor living in MMEM across
                      decode steps; attrs name.  Registered in
                      `Graph.caches` so the stateful executor
                      (repro.npec.exec.DecodeSession) can carry it between
                      steps.  Shape is the cache *capacity* (T, head_dim).
  * ``cache_append``  inputs (cache, new, pos) — write the (1, head_dim)
                      projection into slot `pos` (MWU traffic, folded).
                      The node's value is the updated cache view; it is
                      registered in `Graph.cache_updates` under the cache's
                      name so the executor can persist it.  attr window=True
                      makes the bank a ring: the write wraps to
                      pos % capacity (sliding-window attention; the
                      pos-masked softmax saturates to all-valid once
                      pos >= capacity, which IS the full-ring mask).

Decode-step masking: ``softmax`` takes an optional second input — a scalar
int32 `pos` node — and masks key slots > pos (attr cache_masked); ``rope``
takes an optional second input rotating every row at position `pos` instead
of its static row index.

Chunked-prefill slices (`trace_prefill(cache_len=T)`) reuse the same two
hooks with a *vector* position: the slice's (C,) int32 `pos_ids` input
holds each row's absolute prompt position, so ``softmax`` masks row r to
key slots <= pos_ids[r] (attr row_masked — the causal-slice mask over the
cache), ``rope`` rotates row r at pos_ids[r] (the existing batched-decode
vector path), and ``cache_append`` writes all C rows at their positions
in one MWU burst (attr rows=C).

Batched decode streams (B serving slots sharing ONE stream — the runtime
engine's step, see repro.npec.runtime) add two wrinkles:
  * the `pos` input is a (B,) int32 *vector* (one cache length per slot);
    ``rope`` rotates row s at pos[s], and per-slot softmax masking reads
    its scalar through ``slot_select``;
  * ``slot_select``  inputs (x,); attrs index (slot id).  Slices slot s's
                     row out of a merged (B, ...) tensor — (B, D) -> (1, D)
                     keep-dim, or the (B,) pos vector -> scalar.  Pure
                     MRU row addressing, folded like concat/reshape;
  * ``cache_append`` gains an optional `slot` attr: the new-k/v operand is
                     the merged (B, head_dim) projection and row `slot`
                     is written into that slot's bank at pos[slot].

MoE routing ops (mixture-of-experts streams, mirroring `models/moe.apply`'s
GShard-style capacity dispatch; `MOE_OPS` below is the canonical list the
docs-drift gate in scripts/ci.sh checks against docs/compiler.md):
  * ``topk``          inputs (probs,) for the values node, (probs, values)
                      for the indices node; attrs k, out ("values" |
                      "indices"), renorm (softmax-gate renormalization over
                      the selected k).  The values node is an NVU
                      instruction (k max-select passes); the indices node
                      is produced by the same pass and folds.
  * ``scatter_slot``  inputs (x, expert_ids) — capacity-bounded dispatch:
                      the S*k token-slots scatter into an (E, C, D) buffer
                      at their position-in-expert, dropping slots past
                      capacity C (GShard cumsum semantics).  Lowered to MWU
                      scatter traffic; attrs num_experts, capacity, top_k.
  * ``gather``        expert mode (attrs mode="expert", index=e): slice
                      expert e's (C, D) rows from the dispatch buffer (MRU
                      read).  Combine mode (mode="combine"; inputs
                      (stacked, expert_ids, gates)): gather every surviving
                      token-slot's expert output back to token order and
                      combine weighted by the gates — dropped slots
                      contribute zero, exactly as `models/moe.apply`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

COMPUTE_OPS = ("matmul", "softmax", "layernorm", "rmsnorm", "act", "rope",
               "topk")
FOLDED_OPS = ("input", "param", "add", "mul", "concat", "embed",
              "reshape", "cache", "cache_append", "slot_select")
# MoE routing ops: `topk` values lower to an NVU instruction; `gather` /
# `scatter_slot` lower to MRU/MWU traffic instructions (memory ops, not
# compute).  This tuple is what the ci.sh docs gate greps docs/compiler.md
# for, so the documented op set cannot drift from the IR.
MOE_OPS = ("topk", "gather", "scatter_slot")
MEMORY_OPS = ("gather", "scatter_slot")


@dataclass
class Node:
    id: int
    op: str
    inputs: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: str = "float32"
    attrs: Dict[str, Any] = field(default_factory=dict)
    tag: str = ""


class Graph:
    """Append-only node list; inputs must precede consumers (topo order)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.inputs: Dict[str, int] = {}      # name -> node id
        self.outputs: List[int] = []
        self.caches: Dict[str, int] = {}      # name -> cache node id
        self.cache_updates: Dict[str, int] = {}  # name -> cache_append id
        # serving-prefill graphs: canonical cache name ("enc0.kv0.k") ->
        # the (S, head_dim) node whose rows seed a decode cache bank
        self.kv_exports: Dict[str, int] = {}

    # --- construction ----------------------------------------------------

    def add(self, op: str, inputs: Tuple[int, ...], shape: Tuple[int, ...],
            dtype: str = "float32", tag: str = "", **attrs) -> int:
        assert (op in COMPUTE_OPS or op in FOLDED_OPS
                or op in MEMORY_OPS), op
        nid = len(self.nodes)
        for i in inputs:
            assert 0 <= i < nid, f"node {nid} ({op}) references future node {i}"
        self.nodes.append(Node(nid, op, tuple(inputs), tuple(shape),
                               dtype, dict(attrs), tag))
        return nid

    def add_input(self, name: str, shape: Tuple[int, ...],
                  dtype: str = "float32") -> int:
        nid = self.add("input", (), shape, dtype, tag=name, name=name)
        self.inputs[name] = nid
        return nid

    def add_cache(self, name: str, shape: Tuple[int, ...],
                  dtype: str = "float32") -> int:
        nid = self.add("cache", (), shape, dtype, tag=name, name=name)
        self.caches[name] = nid
        return nid

    def mark_output(self, nid: int) -> int:
        self.outputs.append(nid)
        return nid

    # --- queries ----------------------------------------------------------

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out[i].append(n.id)
        return out

    def count_ops(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op] = out.get(n.op, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        ops = ", ".join(f"{k}={v}" for k, v in sorted(self.count_ops().items()))
        return f"Graph({len(self.nodes)} nodes: {ops})"


class GraphBuilder:
    """Convenience wrapper the tracers drive; one method per IR op."""

    def __init__(self, graph: Optional[Graph] = None):
        self.g = graph if graph is not None else Graph()

    def input(self, name, shape, dtype="float32"):
        return self.g.add_input(name, shape, dtype)

    def param(self, path: Tuple[str, ...], shape, *, layer=None, rows=None,
              cols=None, index=None, tag=""):
        return self.g.add("param", (), shape, tag=tag or ".".join(path),
                          path=tuple(path), layer=layer, rows=rows,
                          cols=cols, index=index)

    def matmul(self, a, b, bias=None, *, transpose_b=False, scale=None,
               quantize=True, tag=""):
        """quantize=False pins a weight-resident matmul to the float path
        even in NPE mode — MoE router/expert matmuls, which
        `models/moe.apply` computes as plain activation-dtype einsums."""
        an, bn = self.g.node(a), self.g.node(b)
        n, k = an.shape[-2], an.shape[-1]
        if transpose_b:
            assert bn.shape[-1] == k, (an.shape, bn.shape)
            m = bn.shape[-2]
        else:
            assert bn.shape[-2] == k, (an.shape, bn.shape)
            m = bn.shape[-1]
        inputs = (a, b) if bias is None else (a, b, bias)
        return self.g.add("matmul", inputs, an.shape[:-2] + (n, m), tag=tag,
                          transpose_b=transpose_b, scale=scale,
                          quantize=quantize)

    def softmax(self, x, *, causal=False, valid_upto=None, tag=""):
        """valid_upto: optional int32 node id (`pos`) — key slots with
        index > pos are masked out (decode over a partial cache).  A
        scalar pos masks every query row the same way (attr cache_masked,
        the one-new-token decode mask); a (C,) vector masks row r to
        slots <= pos[r] (attr row_masked, the chunked-prefill causal
        slice over the cache)."""
        if valid_upto is None:
            return self.g.add("softmax", (x,), self.g.node(x).shape,
                              tag=tag, causal=causal)
        if self.g.node(valid_upto).shape:
            return self.g.add("softmax", (x, valid_upto),
                              self.g.node(x).shape, tag=tag, causal=causal,
                              row_masked=True)
        return self.g.add("softmax", (x, valid_upto), self.g.node(x).shape,
                          tag=tag, causal=causal, cache_masked=True)

    def layernorm(self, x, gamma, beta=None, *, eps=1e-5, tag=""):
        inputs = (x, gamma) if beta is None else (x, gamma, beta)
        return self.g.add("layernorm", inputs, self.g.node(x).shape,
                          tag=tag, eps=eps)

    def rmsnorm(self, x, gamma, *, eps=1e-6, tag=""):
        return self.g.add("rmsnorm", (x, gamma), self.g.node(x).shape,
                          tag=tag, eps=eps)

    def act(self, x, fn: str, tag=""):
        return self.g.add("act", (x,), self.g.node(x).shape, tag=tag, fn=fn)

    def rope(self, x, *, theta=10000.0, pos=None, tag=""):
        """pos: optional scalar int32 node id — rotate every row at that
        position (decode step) instead of its static row index."""
        inputs = (x,) if pos is None else (x, pos)
        return self.g.add("rope", inputs, self.g.node(x).shape, tag=tag,
                          theta=theta)

    def cache(self, name, shape, dtype="float32"):
        return self.g.add_cache(name, shape, dtype)

    def cache_append(self, cache, new, pos, *, slot=None, window=False,
                     tag=""):
        """slot=s (batched decode streams): `new` is the merged (B, hd)
        projection and `pos` the (B,) per-slot position vector — row s is
        written into this cache bank at pos[s].  Without a slot, a `new`
        operand of C > 1 rows (chunked-prefill slices) writes every row r
        at pos[r] in one burst (attr rows=C); the single-row decode write
        is unchanged.

        window=True makes the bank a *ring*: the write lands at
        pos % capacity (sliding-window attention — the bank holds the
        last `capacity` tokens and the position counter keeps growing).
        The pos-masked softmax needs no variant: once pos >= capacity the
        `slot <= pos` mask saturates to all-valid, which is exactly the
        full-ring window mask (`models/transformer.decode_step`'s
        `(arange(wlen) <= pos) | (pos >= wlen)` — the second term is
        redundant given the first saturates)."""
        cn = self.g.node(cache)
        name = cn.attrs["name"]
        ns = self.g.node(new).shape
        rows = (ns[-2] if slot is None and len(ns) >= 2 and ns[-2] > 1
                else None)
        assert not (window and rows), \
            "ring caches take single-row decode writes only"
        nid = self.g.add("cache_append", (cache, new, pos), cn.shape,
                         cn.dtype, tag=tag or f"{name}.append", name=name,
                         slot=slot, rows=rows, window=window)
        self.g.cache_updates[name] = nid
        return nid

    def slot_select(self, x, index, tag=""):
        """Slice slot `index`'s row out of a merged batched tensor:
        (B, D) -> (1, D) keep-dim, or a (B,) pos vector -> scalar ()."""
        xs = self.g.node(x).shape
        assert len(xs) in (1, 2), xs
        shape = () if len(xs) == 1 else (1,) + tuple(xs[1:])
        return self.g.add("slot_select", (x,), shape,
                          dtype=self.g.node(x).dtype, tag=tag, index=index)

    def topk(self, x, k, *, renorm=False, tag=""):
        """Top-k selection over the last axis; returns (values_id,
        indices_id).  renorm=True renormalizes the selected values to sum
        to one (softmax-gate renormalization, `models/moe.apply`).  The
        indices node takes the values node as a second input: both are
        produced by the same NVU max-select pass, so the indices fold onto
        it in lowering."""
        xs = self.g.node(x).shape
        shape = xs[:-1] + (k,)
        vals = self.g.add("topk", (x,), shape, tag=f"{tag}.gates" if tag
                          else "", k=k, out="values", renorm=renorm)
        idx = self.g.add("topk", (x, vals), shape, dtype="int32",
                         tag=f"{tag}.ids" if tag else "", k=k,
                         out="indices")
        return vals, idx

    def scatter_slot(self, x, expert_ids, *, num_experts, capacity, top_k,
                     tag=""):
        """Capacity-bounded dispatch of (S, D) tokens into an
        (num_experts, capacity, D) expert-slot buffer (MWU scatter)."""
        d = self.g.node(x).shape[-1]
        return self.g.add("scatter_slot", (x, expert_ids),
                          (num_experts, capacity, d), tag=tag,
                          num_experts=num_experts, capacity=capacity,
                          top_k=top_k)

    def gather(self, src, *, index=None, expert_ids=None, gates=None,
               num_experts=None, capacity=None, top_k=None, tag=""):
        """MRU gather.  With `index`: slice expert `index`'s (C, D) rows
        from the dispatch buffer.  With (expert_ids, gates): the weighted
        combine of the (E*C, D) stacked expert outputs back to (S, D)
        token order (dropped slots contribute zero)."""
        if index is not None:
            sn = self.g.node(src).shape
            return self.g.add("gather", (src,), sn[-2:], tag=tag,
                              mode="expert", index=index)
        s = self.g.node(expert_ids).shape[-2]
        d = self.g.node(src).shape[-1]
        return self.g.add("gather", (src, expert_ids, gates), (s, d),
                          tag=tag, mode="combine", num_experts=num_experts,
                          capacity=capacity, top_k=top_k)

    def add(self, a, b, tag=""):
        sa, sb = self.g.node(a).shape, self.g.node(b).shape
        shape = sa if len(sa) >= len(sb) else sb
        return self.g.add("add", (a, b), shape, tag=tag)

    def mul(self, a, b, tag=""):
        return self.g.add("mul", (a, b), self.g.node(a).shape, tag=tag)

    def reshape(self, x, shape, tag=""):
        src = self.g.node(x).shape
        n = m = 1
        for s in src:
            n *= s
        for s in shape:
            m *= s
        assert n == m, (src, shape)
        return self.g.add("reshape", (x,), tuple(shape), tag=tag)

    def concat(self, xs, *, axis=-1, tag=""):
        shapes = [self.g.node(x).shape for x in xs]
        dim = sum(s[axis] for s in shapes)
        base = list(shapes[0])
        base[axis] = dim
        return self.g.add("concat", tuple(xs), tuple(base), tag=tag,
                          axis=axis)

    def embed(self, tokens, table, tag=""):
        ts = self.g.node(tokens).shape
        d = self.g.node(table).shape[-1]
        return self.g.add("embed", (tokens, table), ts + (d,), tag=tag)

    def output(self, nid):
        return self.g.mark_output(nid)

"""Functional executor: run a compiled program numerically on torch tensors
(counterpart of `repro/npec/exec.py`).

Interprets the npec graph behind a `CompiledProgram`, node by node in
float32, on one device: the card unless the caller passes device="cpu".
Each node is routed as the reference routes it:
  * weight matmuls   -> NPE-8: `ops.quant_dense`, the `quant_matmul` kernel
                        (activations per row on streams with a vector
                        `pos`); NPE-16: fake quantization and a float32
                        product (`core/quant.dense_maybe_quant`); float: a
                        float32 product; the bias is added after.  Matmuls
                        traced with quantize=False (the MoE router and
                        expert products) stay float32 products in every
                        mode, as `models/moe.apply` computes them;
  * QK^T / AV        -> float32 products on the activation path (never
                        quantized, as `common.attention_scores`);
  * softmax          -> PWL: the `nvu_softmax` kernel with a per-row key
                        limit (`ops.softmax(limit=)`), the masked softmax
                        of `core/nvu.nvu_softmax(where=)`; float:
                        `torch.softmax` with the same mask;
  * layernorm / rmsnorm / act -> the `nvu_layernorm` (RMSNorm as its
                        `rms_only` instance) and `pwl_eval` kernels in PWL
                        mode, exact norms and activations in float mode;
  * rope             -> `common.apply_rope` at each row's position, or at a
                        scalar or per-slot `pos`;
  * MoE routing      -> `models/moe.top_k` (a stable sort: `jax.lax.top_k`'s
                        order among ties) and `renormalize_gates`; the
                        dispatch and combine by `models/moe.dispatch_slots`,
                        an index scatter and gather with the one-hot
                        products' bits, so capacity drops are the model's;
  * embed, add, mul, concat, reshape, cache, cache_append, slot_select -> torch.
On the CPU the kernel wrappers run their plain versions.

Parameters are resolved once: `ParamTree` keeps each param node's slice,
cast to float32 and made contiguous, for every later call that is given
the same tree (`DecodeSession` keeps one).

Buffers live in a node-indexed environment and are freed at last use; the
executor reports the peak live footprint, as the reference does.

Decode streams execute *statefully* through `DecodeSession`: the KV caches
feed in as persistent buffers, each step's `cache_append` results are
carried into the next step, and `pos` advances.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import nvu
from repro_torch.core.quant import dense_maybe_quant
from repro_torch.kernels import ops
from repro_torch.kernels.nvu_softmax import MAX_COLS
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_rope, layernorm_exact, rmsnorm_exact
from repro_torch.npec.ir import FOLDED_OPS, Graph, Node
from repro_torch.npec.lower import CompiledProgram


@dataclass
class ExecResult:
    outputs: List[torch.Tensor]
    peak_live_bytes: int
    n_instrs: int
    # name -> post-step cache value (decode graphs only); DecodeSession
    # persists these into the next step's feeds
    cache_updates: Dict[str, torch.Tensor] = None
    # canonical cache name -> (S, head_dim) k/v rows (serving-prefill
    # graphs only); DecodeSession.load_slot seeds a slot's banks from these
    kv_exports: Dict[str, torch.Tensor] = None

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.outputs[i]


def resolve_device(device) -> torch.device:
    """The executor's device: the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("npec executor: no CUDA device; pass device='cpu' to run "
                           "on the CPU")
    return device


class ParamTree:
    """The parameter tree (nested dicts of tensors, block weights stacked
    over a leading layer axis, as `models/convert.param_tree_from_*` build
    it) with each param node's slice resolved once: indexed, cast to
    float32, made contiguous and moved to `device`, then kept."""

    def __init__(self, tree: Any, device):
        self.tree = tree
        self.device = torch.device(device)
        self._memo: Dict[tuple, torch.Tensor] = {}

    def resolve(self, node: Node) -> torch.Tensor:
        a = node.attrs
        key = (tuple(a["path"]), a.get("layer"), a.get("index"),
               tuple(a["rows"]) if a.get("rows") is not None else None,
               tuple(a["cols"]) if a.get("cols") is not None else None)
        v = self._memo.get(key)
        if v is None:
            v = self.tree
            for k in a["path"]:
                v = v[k]
            v = torch.as_tensor(v)
            if a.get("layer") is not None:
                v = v[a["layer"]]
            if a.get("index") is not None:
                v = v[a["index"]]
            if a.get("rows") is not None:
                r0, r1 = a["rows"]
                v = v[r0:r1]
            if a.get("cols") is not None:
                c0, c1 = a["cols"]
                v = v[..., c0:c1]
            v = self._memo[key] = v.to(device=self.device,
                                       dtype=torch.float32).contiguous()
        return v

    @classmethod
    def on(cls, params: Any, device) -> "ParamTree":
        """`params` as a ParamTree on `device`: itself when it already is
        one there (its resolved slices kept), else a new one."""
        device = torch.device(device)
        if isinstance(params, cls):
            return params if params.device == device else cls(params.tree, device)
        return cls(params, device)


def _matmul(node: Node, a, b, bias, *, weight_resident: bool,
            npe_quant: bool, bits: int, act_axis=None):
    if weight_resident and not node.attrs.get("quantize", True):
        # float-pinned weight matmul (MoE router and expert products):
        # `models/moe.apply` computes these as float products in NPE mode too
        weight_resident = False
    if weight_resident:
        # MMU-resident weight; the tied-embedding logits head is stored
        # transposed, as models/common.logits_out feeds embed.T
        w = b.transpose(-1, -2) if node.attrs.get("transpose_b") else b
        if npe_quant and bits == 8:
            y = ops.quant_dense(a, w, act_axis=act_axis)
        else:
            y = dense_maybe_quant(a, w, None, npe_quant=npe_quant, bits=bits,
                                  act_axis=act_axis)
    elif node.attrs.get("transpose_b"):
        y = torch.matmul(a, b.transpose(-1, -2))
    else:
        y = torch.matmul(a, b)
    if node.attrs.get("scale") is not None:
        y = y * node.attrs["scale"]
    if bias is not None:
        y = y + bias
    return y


def _softmax_limit(node: Node, x, pos):
    """The visible-key count of each row (an int tensor that broadcasts to
    x.shape[:-1]: last axis 1 for one value a matrix), or None for no mask."""
    if node.attrs.get("row_masked"):
        # chunked-prefill slice: row r attends to cache slots <= pos[r]
        return pos.to(torch.int32) + 1
    if node.attrs.get("cache_masked"):
        # decode: every row attends to cache slots <= pos
        return (pos.to(torch.int32) + 1).reshape(*pos.shape, 1)
    if node.attrs.get("causal"):
        return torch.arange(1, x.shape[-2] + 1, dtype=torch.int32, device=x.device)
    return None


def _softmax(node: Node, x, *, pos=None, use_pwl: bool, segments: int):
    limit = _softmax_limit(node, x, pos)
    if use_pwl:
        if x.device.type == "cuda" and x.shape[-1] > MAX_COLS:
            raise ValueError(
                f"npec executor: a softmax over {x.shape[-1]} keys; the nvu_softmax "
                f"kernel holds rows of at most {MAX_COLS} (MAX_COLS), which bounds "
                "the cache capacity and the prefill length on the card")
        return ops.softmax(x, segments=segments, limit=limit)
    where = None
    if limit is not None:
        where = torch.arange(x.shape[-1], device=x.device) < limit[..., None]
        where = where.expand(x.shape)
    return nvu.softmax(x, axis=-1, use_pwl=False, where=where)


def _rmsnorm(node: Node, x, gamma, *, use_pwl: bool, segments: int):
    eps = node.attrs.get("eps", 1e-6)
    if use_pwl:
        return ops.rmsnorm(x, gamma, eps=eps, segments=segments)
    return rmsnorm_exact(x, gamma, eps)


def _rope(node: Node, x, pos=None):
    """pos=None rotates row i at position i (prefill); a scalar `pos`
    rotates every row there (decode: the one new token); a (B,) vector
    rotates row s at pos[s] (batched decode: one merged projection, one
    new token a slot; chunked prefill: each row at its absolute position)."""
    s = x.shape[-2]
    lead = tuple(x.shape[:-2])
    b = 1
    for d in lead:
        b *= d
    x4 = x.reshape(b, s, 1, x.shape[-1])
    if pos is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    elif pos.ndim == 1:
        positions = pos.to(torch.int32).expand(b, s)
    else:
        positions = pos.to(torch.int32).reshape(1, 1).expand(b, s)
    y = apply_rope(x4, positions, node.attrs["theta"])
    return y.reshape(*lead, s, x.shape[-1])


def _topk(node: Node, x):
    """The k largest over the last axis in `jax.lax.top_k`'s order, as
    `models/moe.route` takes them; the values node renormalizes the
    selected gates when the router asks for it (softmax routers, k > 1)."""
    vals, ids = moe_mod.top_k(x, node.attrs["k"])
    if node.attrs["out"] == "indices":
        return ids.to(torch.int32)
    if node.attrs.get("renorm"):
        vals = moe_mod.renormalize_gates(vals)
    return vals


def _dispatch_mask(memo, key, ids_flat, num_experts: int, capacity: int):
    """The dispatch decision of (b, t) expert ids: each assignment's slot in
    its expert and whether it is kept (slot < capacity), from the same
    `models/moe.dispatch_slots` the model calls, so compiled streams drop
    the token-slots the model drops.  Needed twice a MoE layer (scatter and
    combine) from the same ids node, so memoized per `execute` call."""
    k = (key, num_experts, capacity)
    if k not in memo:
        memo[k] = moe_mod.dispatch_slots(ids_flat, num_experts, capacity)
    return memo[k]


def _scatter_slot(node: Node, x, ids, *, memo, key):
    """Capacity-bounded dispatch: (.., S, D) tokens -> (.., E, C, D) slot
    buffers (token-slots past capacity drop; empty slots are zero rows).
    Each kept (token, choice) is copied to its slot: the reference's
    one-hot product, whose every sum has one nonzero term."""
    e, cap, k = node.attrs["num_experts"], node.attrs["capacity"], node.attrs["top_k"]
    lead = tuple(x.shape[:-2])
    s, d = x.shape[-2:]
    xf = x.reshape(-1, s, d)
    b = xf.shape[0]
    ids_flat = ids.reshape(-1, s * k).long()
    slot, kept = _dispatch_mask(memo, key, ids_flat, e, cap)
    x_rep = xf.repeat_interleave(k, dim=1) if k > 1 else xf
    rows = torch.arange(b, device=x.device)[:, None].expand_as(ids_flat)
    # a dropped choice writes a spill slot past the capacity, never read
    buf = x.new_zeros(b, e, cap + 1, d)
    buf[rows, ids_flat, torch.where(kept, slot, cap)] = x_rep
    return buf[:, :, :cap].reshape(*lead, e, cap, d)


def _gather_combine(node: Node, stacked, ids, gates, *, memo, key):
    """Weighted combine of the (.., E*C, D) stacked expert outputs back to
    (.., S, D) token order: each kept (token, choice) takes its gate times
    its slot's row, a dropped one zero, and the k choices are summed; gates
    are not renormalized after a drop (`models/moe.apply`)."""
    e, cap, k = node.attrs["num_experts"], node.attrs["capacity"], node.attrs["top_k"]
    lead = tuple(stacked.shape[:-2])
    d = stacked.shape[-1]
    s = node.shape[-2]
    out_buf = stacked.reshape(-1, e, cap, d)
    b = out_buf.shape[0]
    ids_flat = ids.reshape(-1, s * k).long()
    slot, kept = _dispatch_mask(memo, key, ids_flat, e, cap)
    rows = torch.arange(b, device=stacked.device)[:, None].expand_as(ids_flat)
    picked = out_buf[rows, ids_flat, slot.clamp(max=cap - 1)]
    gated = gates.reshape(-1, s * k)[..., None] * picked
    out = torch.where(kept[..., None], gated, torch.zeros((), dtype=gated.dtype,
                                                         device=gated.device))
    if k > 1:
        out = out.reshape(b, s, k, d).sum(dim=2)
    return out.reshape(*lead, s, d)


def _nbytes(x: torch.Tensor) -> int:
    return int(x.numel()) * x.element_size()


def expected_launches(graph: Graph, *, npe_quant: bool, bits: int,
                      use_pwl: bool) -> Dict[str, int]:
    """Kernel launches that one `execute` of `graph` makes on the card, from
    its nodes: a quantizable weight matmul is one `quant_matmul` at 8 bits
    (a quantize=False one, the MoE router's and experts', none), and each
    softmax, layernorm, rmsnorm and act node one NVU kernel in PWL mode."""
    counts = {"quant_matmul": 0, "nvu_softmax": 0, "nvu_layernorm": 0,
              "pwl_eval": 0, "flash_attention": 0}
    kernel = {"softmax": "nvu_softmax", "layernorm": "nvu_layernorm",
              "rmsnorm": "nvu_layernorm", "act": "pwl_eval"}
    for n in graph.nodes:
        if n.op == "matmul":
            if (npe_quant and bits == 8 and n.attrs.get("quantize", True)
                    and graph.node(n.inputs[1]).op == "param"):
                counts["quant_matmul"] += 1
        elif use_pwl and n.op in kernel:
            counts[kernel[n.op]] += 1
    return counts


def execute(program: Union[CompiledProgram, Graph], params: Any,
            feeds: Dict[str, Any], *, cfg: Optional[ModelConfig] = None,
            npe_quant: bool = False, bits: int = 8, use_pwl: bool = False,
            segments: int = 16, device="cuda") -> ExecResult:
    """Run the program on `feeds` (dict input-name -> array or tensor,
    optionally with a leading batch axis) with `params` (a parameter tree,
    or a `ParamTree` whose slices are kept across calls) on `device`.  NPE
    numerics follow `cfg` when given (npe_quant / npe_quant_bits / npe_pwl /
    npe_pwl_segments), else the explicit keyword flags."""
    device = resolve_device(device)
    graph = program.graph if isinstance(program, CompiledProgram) else program
    n_instrs = (len(program.instrs) if isinstance(program, CompiledProgram)
                else sum(n.op not in FOLDED_OPS for n in graph.nodes))
    if cfg is not None:
        npe_quant, bits = cfg.npe_quant, cfg.npe_quant_bits
        use_pwl, segments = cfg.npe_pwl, cfg.npe_pwl_segments
    params = ParamTree.on(params, device)

    # batched-slot decode streams (vector `pos` input) quantize MMU
    # activations per ROW: each row of a merged (B, K) tile is a different
    # sequence's activation vector
    pos_nid = graph.inputs.get("pos")
    act_axis = (0 if pos_nid is not None and graph.node(pos_nid).shape
                else None)

    env: Dict[int, torch.Tensor] = {}
    uses = {n.id: 0 for n in graph.nodes}
    for n in graph.nodes:
        for i in n.inputs:
            uses[i] += 1
    for o in graph.outputs:
        uses[o] += 1                            # outputs never freed
    for nid in graph.cache_updates.values():
        uses[nid] += 1                          # carried into the next step
    for nid in graph.kv_exports.values():
        uses[nid] += 1                          # handed to load_slot

    live = 0
    peak = 0
    mask_memo: Dict[Any, Any] = {}          # per-call dispatch decisions

    def put(nid: int, val):
        nonlocal live, peak
        env[nid] = val
        live += _nbytes(val)
        peak = max(peak, live)

    def get(nid: int):
        nonlocal live
        val = env[nid]
        uses[nid] -= 1
        if uses[nid] == 0:
            live -= _nbytes(val)
            del env[nid]
        return val

    def feed(name: str, dtype: torch.dtype):
        x = torch.as_tensor(feeds[name])
        if device.type == "cuda" and x.device.type == "cpu":
            # a host feed (tokens, positions) goes through pinned memory, so
            # its copy does not wait for the card's queued work
            return x.to(dtype).pin_memory().to(device, non_blocking=True)
        return x.to(device=device, dtype=dtype)

    for node in graph.nodes:
        op = node.op
        if op == "input":
            put(node.id, feed(node.attrs["name"], torch.int32 if node.dtype == "int32"
                              else torch.float32))
        elif op == "param":
            put(node.id, params.resolve(node))
        elif op == "matmul":
            a, b = get(node.inputs[0]), get(node.inputs[1])
            bias = get(node.inputs[2]) if len(node.inputs) > 2 else None
            wres = graph.node(node.inputs[1]).op == "param"
            put(node.id, _matmul(node, a, b, bias, weight_resident=wres,
                                 npe_quant=npe_quant, bits=bits,
                                 act_axis=act_axis))
        elif op == "softmax":
            x = get(node.inputs[0])
            posv = get(node.inputs[1]) if len(node.inputs) > 1 else None
            put(node.id, _softmax(node, x, pos=posv, use_pwl=use_pwl,
                                  segments=segments))
        elif op == "layernorm":
            x, gamma = get(node.inputs[0]), get(node.inputs[1])
            beta = get(node.inputs[2]) if len(node.inputs) > 2 else None
            eps = node.attrs.get("eps", 1e-5)
            put(node.id, ops.layernorm(x, gamma, beta, eps=eps, segments=segments)
                if use_pwl else layernorm_exact(x, gamma, beta, eps))
        elif op == "rmsnorm":
            put(node.id, _rmsnorm(node, get(node.inputs[0]), get(node.inputs[1]),
                                  use_pwl=use_pwl, segments=segments))
        elif op == "act":
            x = get(node.inputs[0])
            put(node.id, ops.pwl_activation(x, node.attrs["fn"], segments) if use_pwl
                else nvu.activation(node.attrs["fn"], False)(x))
        elif op == "rope":
            x = get(node.inputs[0])
            posv = get(node.inputs[1]) if len(node.inputs) > 1 else None
            put(node.id, _rope(node, x, posv))
        elif op == "add":
            put(node.id, get(node.inputs[0]) + get(node.inputs[1]))
        elif op == "mul":
            put(node.id, get(node.inputs[0]) * get(node.inputs[1]))
        elif op == "concat":
            put(node.id, torch.cat([get(i) for i in node.inputs],
                                   dim=node.attrs["axis"]))
        elif op == "reshape":
            x = get(node.inputs[0])
            src = graph.node(node.inputs[0]).shape
            lead = tuple(x.shape[:x.ndim - len(src)])   # preserved batch axes
            put(node.id, x.reshape(lead + tuple(node.shape)))
        elif op == "embed":
            tokens, table = get(node.inputs[0]), get(node.inputs[1])
            put(node.id, table[tokens.long()])
        elif op == "cache":
            put(node.id, feed(node.attrs["name"], torch.float32))
        elif op == "topk":
            x = get(node.inputs[0])
            if len(node.inputs) > 1:
                get(node.inputs[1])     # the indices ride the values pass
            put(node.id, _topk(node, x))
        elif op == "scatter_slot":
            put(node.id, _scatter_slot(node, get(node.inputs[0]), get(node.inputs[1]),
                                       memo=mask_memo, key=node.inputs[1]))
        elif op == "gather":
            if node.attrs["mode"] == "expert":
                put(node.id, get(node.inputs[0])[..., node.attrs["index"], :, :])
            else:
                put(node.id, _gather_combine(node, get(node.inputs[0]),
                                             get(node.inputs[1]), get(node.inputs[2]),
                                             memo=mask_memo, key=node.inputs[1]))
        elif op == "cache_append":
            c = get(node.inputs[0])
            new = get(node.inputs[1])
            posv = get(node.inputs[2])
            slot = node.attrs.get("slot")
            if slot is not None:
                # batched stream: row `slot` of the merged (B, hd)
                # projection, written at this slot's own position
                new = new[..., slot:slot + 1, :]
                posv = posv[..., slot]
            cap = node.shape[-2]
            if node.attrs.get("rows"):
                # chunked-prefill burst: row r of `new` to slot posv[r],
                # copied exactly (the reference's one-hot product of 1.0 x
                # plus zeros leaves the same values)
                out = c.expand(*new.shape[:-2], *c.shape[-2:]).clone()
                out[..., posv.long(), :] = new
                put(node.id, out)
            else:
                if node.attrs.get("window"):
                    posv = posv % cap      # ring bank: the write wraps
                hit = (torch.arange(cap, device=device) == posv)[:, None]
                put(node.id, torch.where(hit, new, c))
        elif op == "slot_select":
            x = get(node.inputs[0])
            i = node.attrs["index"]
            if len(graph.node(node.inputs[0]).shape) == 1:
                put(node.id, x[..., i])
            else:
                put(node.id, x[..., i:i + 1, :])
        else:
            raise NotImplementedError(f"executor has no rule for {op!r}")

    return ExecResult([env[o] for o in graph.outputs], peak, n_instrs,
                      {name: env[nid]
                       for name, nid in graph.cache_updates.items()},
                      {name: env[nid]
                       for name, nid in graph.kv_exports.items()})


class DecodeSession:
    """Stateful execution of a compiled decode stream.

    The instruction stream is compiled ONCE at cache capacity T, the KV
    caches live across steps, and each `step()` runs the stream at the
    current `pos`: appending the new k/v, masking softmax to the valid
    prefix, and advancing the counter.

    Two stream shapes (distinguished by the graph's `pos` input):

      * **per-sequence** (scalar `pos`, `trace_decode(batch=1)`): one
        position counter; feeds may carry a leading batch axis and the
        whole graph vectorizes over it (`batch=` sizes the caches).
      * **batched-slot** ((B,) `pos`, `trace_decode(batch=B)`): B serving
        slots live *inside* the stream — per-slot cache banks, a per-slot
        position vector, merged B-row weight projections.  Slots advance
        independently: `step(tokens, active=)` bumps only active slots,
        `reset_slot` recycles one, and `load_slot` seeds its banks from an
        executed prefill (`trace_prefill` kv exports).

    `params` is a parameter tree; its slices are resolved once for the
    session.  NPE numerics follow `cfg` when given, else the keyword flags.
    """

    def __init__(self, compiled: CompiledProgram, params: Any, *,
                 batch: int = 1, cfg: Optional[ModelConfig] = None,
                 npe_quant: bool = False, bits: int = 8,
                 use_pwl: bool = False, segments: int = 16, device="cuda"):
        graph = compiled.graph
        if not graph.caches:
            raise ValueError("not a decode graph: no cache nodes "
                             "(trace with repro_torch.npec.trace.trace_decode)")
        self.device = resolve_device(device)
        self.compiled = compiled
        self.params = ParamTree.on(params, self.device)
        self.cfg = cfg
        self.kw = dict(npe_quant=npe_quant, bits=bits, use_pwl=use_pwl,
                       segments=segments)
        pos_shape = graph.node(graph.inputs["pos"]).shape
        self.slots = pos_shape[0] if pos_shape else 1
        self.batched = bool(pos_shape)
        if self.batched and batch != 1:
            raise ValueError(
                "batched-slot streams carry their slots in-graph; "
                "feed-level vectorization (batch != 1) does not apply")
        lead = () if self.batched else (batch,)
        self.caches: Dict[str, torch.Tensor] = {
            name: torch.zeros(lead + tuple(graph.node(nid).shape),
                              dtype=torch.float32, device=self.device)
            for name, nid in graph.caches.items()}
        self.capacity = min(graph.node(nid).shape[-2]
                            for nid in graph.caches.values())
        # ring streams: cache_append wraps at capacity and positions grow
        # unbounded, so the capacity guard does not apply
        self.windowed = any(n.op == "cache_append" and n.attrs.get("window")
                            for n in graph.nodes)
        self.pos = np.zeros(self.slots, np.int64) if self.batched else 0
        self._feed_name = next(n for n in graph.inputs if n != "pos")

    def _run(self, feeds) -> torch.Tensor:
        res = execute(self.compiled, self.params, feeds, cfg=self.cfg,
                      device=self.device, **self.kw)
        self.caches.update(res.cache_updates)
        return res[0]

    # --- per-sequence and batched stepping --------------------------------

    def step(self, tokens, active=None) -> torch.Tensor:
        """Run one decode step.

        Per-sequence streams: `tokens` is (B, 1) int for full graphs, or
        (B, 1, H) hidden states for headless graphs; returns (B, 1, V)
        logits (resp. hidden states) and advances the shared position.

        Batched-slot streams: `tokens` is (B,) (or (B, 1)) int, one token a
        slot, or (B, H) hidden states for headless graphs; `active`
        optionally masks which slots advance their position.  Returns the
        (B, V) step output.  Either mode raises on a pos overflow past the
        compiled cache capacity.
        """
        if not self.batched:
            if self.pos >= self.capacity and not self.windowed:
                raise ValueError(
                    f"KV cache capacity {self.capacity} exhausted at "
                    f"pos={self.pos}; compile a longer stream")
            feeds: Dict[str, Any] = dict(self.caches)
            feeds["pos"] = torch.tensor(self.pos, dtype=torch.int32)
            feeds[self._feed_name] = tokens
            out = self._run(feeds)
            self.pos += 1
            return out
        active = (np.ones(self.slots, bool) if active is None
                  else np.asarray(active, bool))
        if not self.windowed:
            over = np.flatnonzero(active & (self.pos >= self.capacity))
            if over.size:
                raise ValueError(
                    f"KV cache capacity {self.capacity} exhausted for "
                    f"slot(s) {over.tolist()} at "
                    f"pos={self.pos[over].tolist()}; evict or compile a "
                    "longer stream")
        toks = torch.as_tensor(tokens)
        if toks.ndim == 2 and toks.shape[-1] == 1 and toks.dtype != torch.float32:
            toks = toks[:, 0]
        feeds = dict(self.caches)
        feeds["pos"] = torch.from_numpy(self.pos.astype(np.int32))
        feeds[self._feed_name] = toks
        out = self._run(feeds)
        self.pos = self.pos + active.astype(self.pos.dtype)
        return out

    # --- slot lifecycle (batched streams) -----------------------------------

    def _check_slot(self, slot: int) -> None:
        if not self.batched:
            raise ValueError("slot lifecycle applies to batched-slot "
                             "streams (trace_decode(batch=B)) only")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")

    def reset_slot(self, slot: int) -> None:
        """Recycle one slot: zero its cache banks and position counter."""
        self._check_slot(slot)
        key = f".slot{slot}."
        for name in self.caches:
            if key in name:
                self.caches[name] = torch.zeros_like(self.caches[name])
        self.pos[slot] = 0

    def load_slot(self, slot: int, kv: Dict[str, Any], n_tokens: int) -> None:
        """Seed one slot from an executed serving prefill: `kv` maps the
        canonical cache names (`ExecResult.kv_exports`) to (S, head_dim)
        rows, written into this slot's banks at positions [0, S); the
        slot's counter starts at `n_tokens`."""
        self._check_slot(slot)
        if n_tokens > self.capacity:
            raise ValueError(
                f"prefill of {n_tokens} tokens exceeds the compiled cache "
                f"capacity {self.capacity}")
        self.reset_slot(slot)
        for name, rows in kv.items():
            base, leaf = name.rsplit(".", 1)
            bank = f"{base}.slot{slot}.{leaf}"
            if bank not in self.caches:
                raise KeyError(f"no cache bank {bank!r} for export {name!r}")
            arr = torch.as_tensor(rows).to(device=self.device, dtype=torch.float32)
            arr = arr.reshape(arr.shape[-2:])       # drop any lead axes
            self.caches[bank][: arr.shape[0]] = arr
        self.pos[slot] = n_tokens

    # --- bucket migration (length-bucketed serving) ------------------------

    def migrate(self, compiled: CompiledProgram) -> int:
        """Move the live session onto a different-capacity compiled stream:
        every cache bank's live leading rows are copied into a zeroed bank
        of the new capacity; positions and numerics carry over.  Exact:
        rows past a slot's position are inert under the pos-masked softmax.
        Returns the number of live bank rows moved."""
        graph = compiled.graph
        if self.windowed:
            raise ValueError("ring (windowed) streams never migrate — "
                             "the window is the bucket that never grows")
        if set(graph.caches) != set(self.caches):
            raise ValueError(
                "target stream's cache banks do not match this session's "
                "(same model/batch traced at a different capacity required)")
        new_capacity = min(graph.node(nid).shape[-2]
                           for nid in graph.caches.values())
        deepest = int(np.max(self.pos)) if self.batched else int(self.pos)
        if new_capacity < deepest:
            raise ValueError(
                f"cannot migrate to capacity {new_capacity}: slot "
                f"position(s) reach {deepest}")
        moved = 0
        caches: Dict[str, torch.Tensor] = {}
        for name, nid in graph.caches.items():
            old = self.caches[name]
            shape = tuple(graph.node(nid).shape)
            lead = tuple(old.shape[:old.ndim - len(shape)])
            live = self._bank_live_rows(name) if self.batched else deepest
            n = min(live, old.shape[-2], shape[-2])
            buf = torch.zeros(lead + shape, dtype=torch.float32, device=self.device)
            if n:
                buf[..., :n, :] = old[..., :n, :]
            caches[name] = buf
            moved += n
        self.caches = caches
        self.compiled = compiled
        self.capacity = new_capacity
        return moved

    def _bank_live_rows(self, name: str) -> int:
        """Rows of bank `name` holding live tokens: the owning slot's
        position (batched banks are named `...slotS.k/v`)."""
        for s in range(self.slots):
            if f".slot{s}." in name:
                return int(self.pos[s])
        return int(np.max(self.pos))

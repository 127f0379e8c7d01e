"""Stream partitioning: split ONE compiled program across N overlays.

A copy of `repro/npec/fleet/partition.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Both strategies carve a monolithic `CompiledProgram` into per-overlay
sub-programs whose instructions are the *original* lowered instructions
(same ragged-tile MMU charges, same NVU microprogram costs) plus explicit
inter-overlay transfer instructions (`repro_torch.npec.lower.make_transfer`):
activation rows leaving an overlay are an MWU "send", rows landing on one
an MRU "recv", charged at the traffic units' 1-row-per-cycle convention.
Because the transfers are ordinary instructions *inside* the carved
streams, the streaming scheduler overlaps them with compute exactly as it
overlaps MoE dispatch/combine on a single overlay — and fleet reports can
still itemize them via `repro_torch.npec.schedule.transfer_cycles`.

Layer identity comes from the tracer's tag convention (repro_torch.npec.trace):
`enc{l}.*` (bert) / `blk{l}.*` (dense, moe) prefix every in-layer
instruction, `embed.*` precedes the first layer, and the untagged tail
(`ln_f`, `logits`) follows the last.  Per-expert MoE instructions add an
`.x{e}.` component (`blk3.x17.ffg`).

  * `partition_pipeline(compiled, n_stages, rows)` — contiguous layer
    groups (pipeline parallelism): stage s>0 opens with an MRU recv of
    the `rows` boundary activations, stage s<K-1 closes with an MWU send;
    cross-stage data dependencies re-point at the recv.
  * `partition_prefill_decode(prefill_prog, ...)` — prefill/decode
    disaggregation: dedicated prefill overlays run (chunked) prefill and
    ship each finished request's KV cache to a decode overlay as one MWU
    send / MRU recv pair sized from `Graph.kv_exports` — S tokens cross
    as `len(kv_exports) x S` rows (every kv head's k and v row per
    position, the exact rows `DecodeSession.load_slot` seeds).
  * `partition_tensor(compiled, n)` — tensor parallelism for bert/dense
    streams: every projection matmul's output columns split across the N
    overlays at tile granularity (`repro_torch.npec.lower.shard_tile` re-tiles
    each shard through the same row_tiles x k_tiles carving), per-head
    NVU consumers stay home with their head, and the row-parallel
    reductions (attention output projection, FFN down-projection) plus
    the logits all-gather charge `rows x (N-1)` send + recv pairs at
    every shard boundary.
  * `partition_expert(compiled, n)` — expert parallelism for MoE streams:
    the per-expert matmul runs are independent by construction, so
    expert e lands on *relative* overlay e % n (relative to the request's
    home overlay — the fleet rotates homes per request).  The stream
    becomes alternating phases: home phases (attention, router, dispatch,
    combine, shared expert) and expert phases of up to n concurrent
    per-overlay tasks.  Dispatch crossings charge C x E_r rows out of the
    home overlay and into each remote r (C = capacity rows per expert,
    E_r = experts assigned to r); combine charges the same rows back.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.overlay import nvu_cycles
from repro_torch.npec.lower import (CompiledProgram, LoweredInstr, make_transfer,
                              nvu_consume, shard_tile)

_LAYER_RE = re.compile(r"^(?:enc|blk)(\d+)\.")
_EXPERT_RE = re.compile(r"^(?:enc|blk)(\d+)\.x(\d+)\.")
_HEAD_RE = re.compile(r"\.h(\d+)(?:\.|$)")
_KV_RE = re.compile(r"\.kv(\d+)(?:\.|$)")


def instr_layer(tag: str) -> Optional[int]:
    """Layer index a tagged instruction belongs to: `enc{l}.*`/`blk{l}.*`
    -> l, the pre-layer head (`embed.*`) -> -1, and None for the
    post-layer tail (`ln_f`, `logits`)."""
    m = _LAYER_RE.match(tag)
    if m:
        return int(m.group(1))
    if tag.startswith("embed"):
        return -1
    return None


def _carve(compiled: CompiledProgram, ids: List[int], *,
           recv_rows: int = 0, send_rows: int = 0,
           tag: str = "xfer") -> CompiledProgram:
    """Extract `ids` (emission order) into a standalone sub-program.

    Dependencies on instructions outside the carve are satisfied by the
    shard's MRU recv when one exists (`recv_rows > 0`) — the rows those
    producers computed arrive over the interconnect — and dropped
    otherwise (the fleet simulator then sequences the shards with an
    explicit barrier, e.g. expert phases).  `send_rows > 0` appends an
    MWU send depending on every sink, so the boundary activations cannot
    leave before the shard's compute retires them."""
    instrs: List[LoweredInstr] = []
    new_index: Dict[int, int] = {}
    if recv_rows:
        instrs.append(make_transfer("MRU", recv_rows, (), f"{tag}.recv"))
    for oi in ids:
        ins = compiled.instrs[oi]
        deps = []
        for d in ins.deps:
            nd = new_index.get(d, 0 if recv_rows else None)
            if nd is not None and nd not in deps:
                deps.append(nd)
        new_index[oi] = len(instrs)
        instrs.append(LoweredInstr(ins.unit, ins.op, ins.cycles,
                                   tuple(deps), ins.tag, ins.shape,
                                   ins.node, ins.meta))
    if send_rows:
        consumed = {d for ins in instrs for d in ins.deps}
        sinks = tuple(i for i in range(len(instrs)) if i not in consumed)
        instrs.append(make_transfer("MWU", send_rows, sinks, f"{tag}.send"))
    return CompiledProgram(compiled.graph, compiled.hw, compiled.bits,
                           compiled.nvu_source, instrs, {})


# --- pipeline parallelism (bert / dense) -------------------------------


@dataclass
class PipelinePlan:
    """Contiguous layer groups of one compiled stream, one per stage."""
    stages: List[CompiledProgram]
    rows: int                       # boundary activation rows per crossing
    layer_groups: List[List[int]]   # model layers per stage


def partition_pipeline(compiled: CompiledProgram, n_stages: int, *,
                       rows: int) -> PipelinePlan:
    """Split a bert/dense stream into `n_stages` contiguous layer groups.
    `rows` is the activation rows crossing each stage boundary (the
    hidden-state rows in flight: S for a prefill stream, B slots for a
    batched decode stream)."""
    layers = sorted({l for ins in compiled.instrs
                     for l in [instr_layer(ins.tag)]
                     if l is not None and l >= 0})
    if not layers:
        raise ValueError("stream has no layer-tagged instructions")
    if not 1 <= n_stages <= len(layers):
        raise ValueError(
            f"cannot split {len(layers)} layers into {n_stages} stages")
    # contiguous split, earlier stages take the remainder
    per, extra = divmod(len(layers), n_stages)
    groups: List[List[int]] = []
    at = 0
    for s in range(n_stages):
        take = per + (1 if s < extra else 0)
        groups.append(layers[at:at + take])
        at += take
    stage_of = {l: s for s, grp in enumerate(groups) for l in grp}
    ids: List[List[int]] = [[] for _ in range(n_stages)]
    for i, ins in enumerate(compiled.instrs):
        l = instr_layer(ins.tag)
        if l is None:                       # ln_f / logits tail
            ids[n_stages - 1].append(i)
        elif l < 0:                         # embed head
            ids[0].append(i)
        else:
            ids[stage_of[l]].append(i)
    stages = [
        _carve(compiled, ids[s],
               recv_rows=rows if s > 0 else 0,
               send_rows=rows if s < n_stages - 1 else 0,
               tag=f"xfer.s{s}")
        for s in range(n_stages)
    ]
    return PipelinePlan(stages=stages, rows=int(rows), layer_groups=groups)


# --- prefill/decode disaggregation -------------------------------------


@dataclass
class PrefillDecodePlan:
    """KV-shipping plan for a disaggregated fleet: `kv_rows_per_token`
    rows cross per prompt token (one (head_dim,) row per kv export — the
    k and v bank rows of every kv head, `Graph.kv_exports`), so a
    finished S-token prefill ships `kv_rows_per_token * S` rows out of
    its prefill overlay (MWU send) and into its decode overlay (MRU
    recv), both at the traffic units' 1-row-per-cycle convention."""
    kv_rows_per_token: int
    prefill_overlays: int
    decode_overlays: int
    _src: CompiledProgram = field(repr=False)
    _send: Dict[int, CompiledProgram] = field(default_factory=dict,
                                              repr=False)
    _recv: Dict[int, CompiledProgram] = field(default_factory=dict,
                                              repr=False)

    def kv_rows(self, seq: int) -> int:
        return self.kv_rows_per_token * int(seq)

    def send_prog(self, seq: int) -> CompiledProgram:
        """MWU stream shipping an S-token KV cache off a prefill overlay."""
        if seq not in self._send:
            self._send[seq] = _carve(self._src, [],
                                     send_rows=self.kv_rows(seq),
                                     tag=f"kv.s{seq}")
        return self._send[seq]

    def recv_prog(self, seq: int) -> CompiledProgram:
        """MRU stream landing an S-token KV cache on a decode overlay."""
        if seq not in self._recv:
            self._recv[seq] = _carve(self._src, [],
                                     recv_rows=self.kv_rows(seq),
                                     tag=f"kv.s{seq}")
        return self._recv[seq]


def partition_prefill_decode(prefill_prog: CompiledProgram, *,
                             prefill_overlays: int,
                             decode_overlays: int) -> PrefillDecodePlan:
    """Build the KV-shipping plan for a disaggregated fleet from a
    compiled serving-prefill stream (`compile_prefill` — its
    `Graph.kv_exports` names every cache-bank row family a decode slot
    needs).  The prefill overlays run the (chunked) prefill streams
    themselves; this plan only sizes the inter-overlay handoff."""
    if prefill_overlays < 1 or decode_overlays < 1:
        raise ValueError(
            f"need at least one overlay on each side, got "
            f"{prefill_overlays} prefill + {decode_overlays} decode")
    kv = prefill_prog.graph.kv_exports
    if not kv:
        raise ValueError(
            "prefill stream has no kv exports to ship; compile it with "
            "compile_prefill (trace_prefill), not compile_model")
    return PrefillDecodePlan(kv_rows_per_token=len(kv),
                             prefill_overlays=prefill_overlays,
                             decode_overlays=decode_overlays,
                             _src=prefill_prog)


# --- expert parallelism (moe) ------------------------------------------


@dataclass
class ShardTask:
    """One overlay's work inside a phase.  `rel` is the overlay index
    RELATIVE to the request's home (0 = home); `xfer_rows` the transfer
    rows charged inside this task's stream (itemizable)."""
    rel: int
    prog: CompiledProgram
    xfer_rows: int = 0


@dataclass
class Phase:
    """Concurrent tasks separated from the next phase by a barrier (the
    home stream cannot combine until every remote expert returns)."""
    tasks: List[ShardTask] = field(default_factory=list)


@dataclass
class ExpertPlan:
    phases: List[Phase]
    overlays: int
    capacity: int                  # C rows per expert slot (dispatch meta)

    @property
    def transfer_rows(self) -> int:
        return sum(t.xfer_rows for ph in self.phases for t in ph.tasks)


def _expert_runs(compiled: CompiledProgram
                 ) -> List[Tuple[str, List[int]]]:
    """Split emission order into alternating ("home", ids) and
    ("expert", ids) runs — per-expert instructions are emitted
    contiguously per layer (trace._moe_ffn)."""
    runs: List[Tuple[str, List[int]]] = []
    for i, ins in enumerate(compiled.instrs):
        kind = "expert" if _EXPERT_RE.match(ins.tag) else "home"
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(i)
        else:
            runs.append((kind, [i]))
    return runs


def partition_expert(compiled: CompiledProgram, n: int) -> ExpertPlan:
    """Shard a MoE stream's per-expert runs across `n` overlays.

    Walks the emission order into home/expert runs.  Each expert run
    becomes one phase of up to `n` concurrent tasks (expert e -> relative
    overlay e % n; relative overlay 0 is the home, which keeps its share
    of experts with no crossing).  The *preceding* home run closes with
    the dispatch send (C x E_r rows to every remote r), the *following*
    home run opens with the combine recv of the same rows — matching the
    MWU scatter / MRU gather the monolithic stream already charges for
    the on-overlay dispatch buffer."""
    if n < 1:
        raise ValueError(f"need at least one overlay, got {n}")
    runs = _expert_runs(compiled)
    if not any(kind == "expert" for kind, _ in runs):
        raise ValueError("stream has no per-expert runs to shard "
                         "(expert parallelism needs a moe-family stream)")
    capacity = 0
    # per-run remote crossing rows: C x E_r summed over remotes r > 0
    crossings: List[int] = []
    per_run_tasks: List[Optional[List[Tuple[int, List[int], int]]]] = []
    for kind, ids in runs:
        if kind == "home":
            crossings.append(0)
            per_run_tasks.append(None)
            continue
        by_rel: Dict[int, List[int]] = {}
        experts: Dict[int, int] = {}
        cap = 0
        for i in ids:
            m = _EXPERT_RE.match(compiled.instrs[i].tag)
            e = int(m.group(2))
            rel = e % n
            by_rel.setdefault(rel, []).append(i)
            experts[e] = rel
            ins = compiled.instrs[i]
            if ins.op == "gather":              # expert slot read: C rows
                cap = max(cap, int(ins.meta["rows"]))
        capacity = max(capacity, cap)
        tasks = []
        remote_rows = 0
        for rel in sorted(by_rel):
            e_r = sum(1 for r in experts.values() if r == rel)
            rows = cap * e_r if rel > 0 else 0
            remote_rows += rows
            tasks.append((rel, by_rel[rel], rows))
        crossings.append(remote_rows)
        per_run_tasks.append(tasks)
    phases: List[Phase] = []
    for ri, (kind, ids) in enumerate(runs):
        if kind == "home":
            recv = crossings[ri - 1] if ri > 0 else 0
            send = crossings[ri + 1] if ri + 1 < len(runs) else 0
            prog = _carve(compiled, ids, recv_rows=recv, send_rows=send,
                          tag=f"xfer.h{ri}")
            phases.append(Phase([ShardTask(0, prog, recv + send)]))
        else:
            tasks = []
            for rel, rel_ids, rows in per_run_tasks[ri]:
                prog = _carve(compiled, rel_ids, recv_rows=rows,
                              send_rows=rows, tag=f"xfer.e{ri}.r{rel}")
                tasks.append(ShardTask(rel, prog, 2 * rows))
            phases.append(Phase(tasks))
    return ExpertPlan(phases=phases, overlays=n, capacity=capacity)


# --- tensor parallelism (bert / dense) ---------------------------------

# projection classification by tag tail (repro_torch.npec.trace conventions):
# column-parallel matmuls keep a balanced slice of the output columns on
# every overlay; row-parallel matmuls split the contraction (each overlay
# computes a partial sum over its own heads' / FFN columns' slice) and
# close with an all-reduce; the logits head is column-parallel over the
# vocab and closes with an all-gather so every overlay can sample.
_COL_TAILS = ("ff1", "ffg", "ffu")
_ROW_TAILS = ("ff2", "ffd")


def _mm_kind(tag: str) -> Optional[str]:
    if tag.endswith(".attn.out"):
        return "reduce"
    tail = tag.rsplit(".", 1)[-1]
    if tail in _ROW_TAILS:
        return "reduce"
    if tail in _COL_TAILS:
        return "col"
    if tail == "logits":
        return "gather"
    return None


@dataclass
class TensorPlan:
    """Column-carved shards of one compiled stream, one per overlay.

    Every shard is a complete stream for its slice of the model — its
    heads' attention, its columns of the FFN, its slice of the vocab —
    synchronized with its peers at `boundaries` all-reduce/all-gather
    points, each charging `rows x (overlays - 1)` send + recv rows on
    every shard (`transfer_rows_per_shard`)."""
    shards: List[CompiledProgram]
    overlays: int
    rows: int                      # activation rows in flight (S or B)
    heads: int                     # attention heads carved across shards
    kv_heads: int                  # kv groups carved across shards
    boundaries: int                # sync points per shard stream

    @property
    def transfer_rows_per_shard(self) -> int:
        return 2 * self.rows * (self.overlays - 1) * self.boundaries

    @property
    def transfer_rows(self) -> int:
        return self.overlays * self.transfer_rows_per_shard


def _head_counts(compiled: CompiledProgram) -> Tuple[int, int]:
    """(heads, kv_heads) carried by a stream's tags.  Decode streams name
    kv groups outright (`.kv{j}.`); prefill streams tag k/v projections
    under each group's first head, so the kv count is how many distinct
    heads own a `.k` projection."""
    heads = set()
    kvs = set()
    k_owners = set()
    for ins in compiled.instrs:
        m = _HEAD_RE.search(ins.tag)
        if m:
            heads.add(int(m.group(1)))
            if ins.tag.rsplit(".", 1)[-1] == "k":
                k_owners.add(int(m.group(1)))
        m = _KV_RE.search(ins.tag)
        if m:
            kvs.add(int(m.group(1)))
    n_heads = (max(heads) + 1) if heads else 0
    if kvs:
        n_kv = max(kvs) + 1
    elif k_owners:
        n_kv = len(k_owners)
    else:
        n_kv = n_heads
    return n_heads, n_kv


def partition_tensor(compiled: CompiledProgram, n: int) -> TensorPlan:
    """Carve a bert/dense stream into `n` tensor-parallel column shards.

    Per-head work (q/k/v projections, qk, softmax, av, rope) lands whole
    on the overlay owning the head — heads split into contiguous blocks
    of `heads/n`, kv groups into blocks of `kv_heads/n`, so a group's
    grouped-query consumers always live with its k/v banks.  FFN up
    projections split their output columns `m/n` per overlay (the
    elementwise activation scales with them); the attention output
    projection and FFN down projection split the *contraction* instead —
    each overlay multiplies its own slice against its rows of the weight
    and the partial sums meet in an all-reduce charged as paired MWU
    send / MRU recv of `rows x (n-1)` each.  The logits head splits the
    vocab columns and closes with the same-shaped all-gather.  Layer
    norms replicate whole (every overlay needs the full hidden state to
    re-enter its columns), matching Megatron-style tensor parallelism.
    Tokens are therefore bit-identical to the monolithic stream — only
    cycles move."""
    if n < 1:
        raise ValueError(f"need at least one overlay, got {n}")
    heads, kv_heads = _head_counts(compiled)
    if heads == 0:
        raise ValueError("stream has no per-head attention tags to carve "
                         "(tensor parallelism needs a bert/dense stream)")
    if heads % n or kv_heads % n:
        raise ValueError(
            f"tensor parallelism carves attention head-wise: {heads} heads"
            f" / {kv_heads} kv heads must divide across {n} overlays")
    rows = next((ins.shape[0] for ins in compiled.instrs
                 if ins.unit == "MMU"), 1)
    if n == 1:
        return TensorPlan(shards=[compiled], overlays=1, rows=int(rows),
                          heads=heads, kv_heads=kv_heads, boundaries=0)
    hw, bits = compiled.hw, compiled.bits
    h_per, kv_per = heads // n, kv_heads // n
    xfer_rows = int(rows) * (n - 1)

    def owner(tag: str) -> Optional[int]:
        m = _HEAD_RE.search(tag)
        if m:
            return int(m.group(1)) // h_per
        m = _KV_RE.search(tag)
        if m:
            return int(m.group(1)) // kv_per
        return None

    shards: List[CompiledProgram] = []
    boundaries = 0
    for s in range(n):
        instrs: List[LoweredInstr] = []
        new_index: Dict[int, int] = {}
        last_sync: Optional[int] = None
        boundaries = 0

        def mapped_deps(ins: LoweredInstr) -> Tuple[int, ...]:
            # deps on instructions another shard owns are satisfied by the
            # last all-reduce: their contribution arrived with the reduced
            # activations (dropped before the first boundary — the carved
            # prologue has no cross-shard consumers yet)
            deps: List[int] = []
            for d in ins.deps:
                nd = new_index.get(d, last_sync)
                if nd is not None and nd not in deps:
                    deps.append(nd)
            return tuple(deps)

        def boundary(oi: int, ins: LoweredInstr, kind: str) -> None:
            nonlocal last_sync, boundaries
            mi = new_index[oi]
            send = make_transfer("MWU", xfer_rows, (mi,),
                                 f"{kind}.{ins.tag}.send")
            si = len(instrs)
            instrs.append(send)
            recv = make_transfer("MRU", xfer_rows, (si,),
                                 f"{kind}.{ins.tag}.recv")
            new_index[oi] = len(instrs)     # consumers see the synced value
            instrs.append(recv)
            last_sync = new_index[oi]
            boundaries += 1

        for oi, ins in enumerate(compiled.instrs):
            own = owner(ins.tag)
            if own is not None and own != s:
                continue
            deps = mapped_deps(ins)
            if ins.unit == "MMU" and own is None:
                kind = _mm_kind(ins.tag)
                if kind is not None:
                    mm_n, mm_k, mm_m = ins.shape
                    axis = "k" if kind == "reduce" else "m"
                    if axis == "m" and kind == "col" and mm_m % n:
                        raise ValueError(
                            f"tensor parallelism carves {ins.tag} "
                            f"column-wise: FFN width {mm_m} must divide "
                            f"across {n} overlays")
                    st = shard_tile(hw, mm_n, mm_k, mm_m, bits,
                                    idx=s, of=n, axis=axis)
                    new_index[oi] = len(instrs)
                    instrs.append(LoweredInstr(
                        "MMU", "matmul", st["cycles"], deps, ins.tag,
                        (st["n"], st["k"], st["m"]), ins.node,
                        meta=dict(tiling=st["tiling"], stream=st["stream"],
                                  weight_resident=ins.meta.get(
                                      "weight_resident", True),
                                  shard=st["shard"])))
                    if kind == "reduce":
                        boundary(oi, ins, "allreduce")
                    elif kind == "gather":
                        boundary(oi, ins, "allgather")
                    continue
            if ins.unit == "NVU" and own is None \
                    and ins.meta.get("ir_op") == "act":
                # elementwise activation over a column-split FFN: each
                # overlay sweeps only its own slice of the elements
                n_el = ins.shape[0]
                el = n_el // n + (1 if s < n_el % n else 0)
                charged = nvu_cycles(hw, ins.op, el, compiled.nvu_source)
                meta = dict(ins.meta,
                            consume=nvu_consume(hw, charged, el),
                            model_cycles=nvu_cycles(hw, ins.op, el,
                                                    "model"),
                            shard=dict(idx=s, of=n, elements=el,
                                       full_elements=n_el))
                new_index[oi] = len(instrs)
                instrs.append(LoweredInstr(
                    "NVU", ins.op, charged, deps, ins.tag, (el,),
                    ins.node, meta))
                continue
            # owned-whole (per-head work) or replicated-whole (layer
            # norms, structural traffic): the original instruction rides
            # along at its original charge
            new_index[oi] = len(instrs)
            instrs.append(LoweredInstr(ins.unit, ins.op, ins.cycles, deps,
                                       ins.tag, ins.shape, ins.node,
                                       ins.meta))
        shards.append(CompiledProgram(compiled.graph, hw, bits,
                                      compiled.nvu_source, instrs, {}))
    return TensorPlan(shards=shards, overlays=n, rows=int(rows),
                      heads=heads, kv_heads=kv_heads, boundaries=boundaries)

"""Lowering: npec graph IR -> overlay instruction stream.

A copy of `repro/npec/lower.py` in the port, which imports nothing of the reference
package; the cycle figures are the FPGA overlay model's, never a GPU's.

Three jobs (paper §5, §6):

1. **Matmul tiling** — every matmul is tiled to the MMU geometry (128 PEs
   x `mmu_macs(bits)` MACs, paper §5.4): output rows tile over PEs, the
   contraction tiles over MAC depth, and each (row, K) tile streams its
   output columns one per cycle.  The *charged* instruction cost is the
   padded `overlay.mmu_tiled_cycles` — what the geometry actually executes,
   ragged edges included (equal to the ideal MAC rate for aligned shapes;
   the hand-built cross-check charges the same).  Each instruction carries
   its explicit tile stream (`meta["stream"]`: per-tile cycle slices) so
   the streaming scheduler can overlap consumers with partial producers,
   and `meta["tiling"]` keeps the ideal-rate floor and padding efficiency.

2. **NVU microprograms** — each nonlinearity expands into the shared pass
   structure `overlay.ROUTINE_PASSES`, bundled into VLIW issue slots
   (1 LSU + 3 VCU + 1 SCU per bundle, §6.1) with the 32 vector registers
   allocated by linear scan.  The resulting bundle counts reproduce
   `overlay.nvu_cycles(source="model")` exactly (asserted at lower time),
   so the micro and macro cost models cannot drift apart.

3. **Dependency resolution** — structural ops (residual adds, head
   concat, gating muls, embedding gathers, and the decode streams'
   cache / cache_append ops — MMEM-resident state and its MWU write
   traffic) fold into the producing stream's epilogue / MRU-MWU traffic,
   exactly as the hand-built program models them; their consumers inherit
   the producers' dependencies.

Decode streams are dominated by *skinny* matmuls — (1, H) projections
whose single output row lights up one of the 128 PE rows.  Those tiles
now charge what they actually cost (the padded tile rate), so per-step
decode cycles ARE the sustained rate; `CompiledProgram.
mmu_tiling_summary()` reports the ragged 1-row occupancy and asserts the
per-tile charges add up to the scheduled instruction costs.

MoE routing streams add three more op classes:
  * ``topk`` (values) -> an NVU instruction of k max-select passes, each
    costed at the elementwise PWL-class (gelu) rate over the probability
    rows (the NVU has no sorter — top-k is k vector-max sweeps);
  * ``scatter_slot`` -> an MWU scatter instruction (one cycle per
    dispatched token-slot row) and ``gather`` -> an MRU instruction (one
    cycle per row read), making the dispatch/combine *traffic* visible in
    the schedule instead of folding it;
  * the E per-expert FFN matmuls are ordinary MMU instructions over
    C-row tiles, so `mmu_tiling_summary()` charges their skinny-tile
    padding exactly like decode's 1-row projections (C < 128 PE rows for
    every realistic capacity).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.overlay import (Instr, NPEHardware, Pass, Program,
                                ROUTINE_PASSES, ROUTINE_STALL_FACTOR,
                                mmu_cycles, mmu_tiled_cycles, nvu_cycles)
from repro_torch.npec.ir import Graph, Node

# IR op -> NVU routine (cost class).  Elementwise PWL streams (activations,
# rotary arithmetic) all run at the GELU rate: load, PWL/vector math, store.
NVU_ROUTINE_FOR = {
    "softmax": "softmax",
    "layernorm": "layernorm",
    "rmsnorm": "layernorm",   # conservatively costed with the mean pass
    "act": "gelu",
    "rope": "gelu",
}


# ---------------------------------------------------------------------------
# Matmul tiling (MMU geometry)
# ---------------------------------------------------------------------------

def tile_matmul(hw: NPEHardware, n: int, k: int, m: int,
                bits: int) -> Dict[str, Any]:
    """Tile an (n,k)@(k,m) matmul onto the MMU: `row_tiles` PE-row blocks x
    `k_tiles` MAC-depth blocks, each streaming `m` output columns at one
    column/cycle.  For MMU-aligned shapes tiled == ideal; ragged shapes pay
    padding (reported as `efficiency`).  The instruction *charges*
    `tiled_cycles` (what the geometry actually executes); `ideal_cycles`
    is the paper's MAC-rate floor."""
    row_tiles = math.ceil(n / hw.mmu_pes)
    k_tiles = math.ceil(k / hw.mmu_macs(bits))
    tiled = mmu_tiled_cycles(hw, n, k, m, bits)
    ideal = mmu_cycles(hw, n, k, m, bits)
    assert tiled == row_tiles * k_tiles * m
    return dict(row_tiles=row_tiles, k_tiles=k_tiles, cols=m,
                tiles=row_tiles * k_tiles, tiled_cycles=tiled,
                ideal_cycles=ideal, efficiency=ideal / tiled)


def tile_stream(tiling: Dict[str, Any]) -> Dict[str, int]:
    """The per-tile cycle slices a lowered matmul streams through the MMU:
    `slices` tiles of `slice_cycles` each (every tile streams the output
    columns at one per cycle), delivering output progressively.  The
    streaming scheduler (`repro.npec.schedule.stream_schedule`) treats the
    first slice as the earliest point a rate-matched consumer can start —
    the fluid tile-stream abstraction behind the paper's §7.2 budget
    analysis.  Invariant: slices * slice_cycles == tiled_cycles (the
    charged instruction cost; asserted by `mmu_tiling_summary`)."""
    return dict(slices=tiling["tiles"], slice_cycles=tiling["cols"])


def shard_tile(hw: NPEHardware, n: int, k: int, m: int, bits: int, *,
               idx: int, of: int, axis: str) -> Dict[str, Any]:
    """Re-tile one tensor-parallel shard of an (n,k)@(k,m) matmul
    (repro.npec.fleet.partition_tensor).  ``axis="m"`` keeps shard `idx`'s
    slice of the N output columns (column-parallel: each overlay streams
    its own `m//of` columns through the same row_tiles x k_tiles carving,
    balanced when `m % of != 0`); ``axis="k"`` keeps its slice of the
    contraction (row-parallel: each overlay computes a partial sum over
    `k//of` of the K inputs, reduced at the shard boundary).  Returns the
    shard's `tiling` + `stream` metadata — the same per-tile carving
    `tile_matmul` emits, so `mmu_tiling_summary`'s slices x slice_cycles
    invariant holds on sharded streams too."""
    if axis not in ("m", "k"):
        raise ValueError(f"shard axis must be 'm' or 'k', got {axis!r}")
    if not 0 <= idx < of:
        raise ValueError(f"shard index {idx} outside fleet of {of}")
    full_k, full_m = k, m
    if axis == "m":
        m = m // of + (1 if idx < m % of else 0)
        if m == 0:
            # the reference divides by this shard's zero tiled cycles here
            raise ValueError(
                f"column shard {idx} of {of} gets no columns: m={full_m} "
                f"output columns do not reach every overlay (need m >= of)")
    else:
        if k % of:
            raise ValueError(
                f"contraction dim {k} does not divide across {of} overlays")
        k = k // of
    tiling = tile_matmul(hw, n, k, m, bits)
    return dict(cycles=tiling["tiled_cycles"], n=n, k=k, m=m,
                tiling=tiling, stream=tile_stream(tiling),
                shard=dict(idx=idx, of=of, axis=axis,
                           full_k=full_k, full_m=full_m))


def nvu_consume(hw: NPEHardware, cycles: int, n_elements: int,
                elem_bits: int = 16) -> Dict[str, int]:
    """Rate-matched consumption profile of an NVU instruction: the routine
    sweeps `chunks` vector-register chunks over its input, so it can begin
    once the producer's first tile lands and needs `tail_cycles` (one
    chunk's worth of work) after the producer's *last* tile to drain —
    the two constants `stream_schedule` uses to pipeline a nonlinearity
    under its producing matmul."""
    chunks = max(1, math.ceil(n_elements / hw.lanes(elem_bits)))
    return dict(chunks=chunks, tail_cycles=math.ceil(cycles / chunks))


# ---------------------------------------------------------------------------
# NVU microprograms: VLIW bundling + vector-register allocation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MicroOp:
    slot: str                      # "lsu" | "vcu" | "scu"
    name: str
    dst: Optional[str] = None      # virtual register written (None = store)
    srcs: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Bundle:
    """One VLIW issue cycle: <=1 LSU, <=3 VCU, <=1 SCU op."""
    ops: Tuple[MicroOp, ...]


@dataclass
class PassMicro:
    bundles: Tuple[Bundle, ...]    # steady-state bundles per chunk
    reduce_tail: int               # intra-vector tree cycles at pass end
    scalar: int                    # SCU tail cycles (PWL recip/rsqrt, ...)


@dataclass
class NVUMicroprogram:
    routine: str
    passes: Tuple[PassMicro, ...]
    reg_map: Dict[str, int]        # virtual -> physical vector register
    regs_used: int
    unroll: int                    # chunk software-pipelining depth

    def cycles(self, hw: NPEHardware, n_elements: int,
               elem_bits: int = 16) -> int:
        """Bundle-accurate cycle count; equals nvu_cycles(source="model")."""
        chunks = math.ceil(n_elements / hw.lanes(elem_bits))
        stall = ROUTINE_STALL_FACTOR.get(self.routine, 1)
        total = 0
        for p in self.passes:
            total += len(p.bundles) * stall * chunks + p.reduce_tail + p.scalar
        return total


def _pass_micro_ops(p: Pass, pi: int) -> List[MicroOp]:
    """Expand one Pass into named micro-ops over virtual registers: a load
    defining the chunk input, a VCU chain (the last op accumulates into the
    pass accumulator when the pass reduces), an optional store, and SCU
    tail ops reading the accumulator."""
    ops: List[MicroOp] = []
    inp = f"p{pi}.in"
    ops.append(MicroOp("lsu", "ld", dst=inp))
    prev = inp
    for vi in range(p.vcu):
        last = vi == p.vcu - 1
        if p.reduce_tail and last:
            acc = f"p{pi}.acc"
            ops.append(MicroOp("vcu", f"vacc{vi}", dst=acc, srcs=(prev, acc)))
        else:
            dst = f"p{pi}.v{vi}"
            ops.append(MicroOp("vcu", f"vop{vi}", dst=dst, srcs=(prev,)))
            prev = dst
    if p.lsu > 1:
        for si in range(p.lsu - 1):
            ops.append(MicroOp("lsu", f"st{si}", srcs=(prev,)))
    for si in range(p.scalar):
        ops.append(MicroOp("scu", f"s{si}", srcs=(f"p{pi}.acc",)
                           if p.reduce_tail else (prev,)))
    return ops


def _bundle(ops: Sequence[MicroOp], hw: NPEHardware) -> Tuple[Bundle, ...]:
    """Greedy earliest-fit slot packing.  Intra-chunk RAW hazards are
    hidden by software-pipelining `unroll` chunks deep (the classic VLIW
    schedule), so only the issue widths constrain steady state.  Pass-end
    SCU tails are counted separately (PassMicro.scalar), not packed."""
    caps = {"lsu": hw.lsu_issue, "vcu": hw.vcu_issue, "scu": hw.scu_issue}
    slots: List[Dict[str, int]] = []
    packed: List[List[MicroOp]] = []
    for op in ops:
        if op.slot == "scu":
            continue
        placed = False
        for i, used in enumerate(slots):
            if used[op.slot] < caps[op.slot]:
                used[op.slot] += 1
                packed[i].append(op)
                placed = True
                break
        if not placed:
            slots.append({"lsu": 0, "vcu": 0, "scu": 0, op.slot: 1})
            packed.append([op])
    if not packed:                              # degenerate all-scalar pass
        packed.append([])
    return tuple(Bundle(tuple(b)) for b in packed)


def _linear_scan(all_ops: Sequence[Sequence[MicroOp]],
                 num_vregs: int) -> Tuple[Dict[str, int], int]:
    """Linear-scan allocation of virtual vector registers to the NVU's
    physical file.  Accumulators live for their whole pass; everything else
    frees at last use.  Returns (mapping, peak_live)."""
    intervals: Dict[str, List[int]] = {}
    t = 0
    for pass_ops in all_ops:
        for op in pass_ops:
            if op.dst is not None and op.slot != "scu":
                intervals.setdefault(op.dst, [t, t])[1] = t
            for s in op.srcs:
                if s in intervals:
                    intervals[s][1] = t
                else:                          # acc read before first def
                    intervals.setdefault(s, [t, t])[1] = t
            t += 1
    reg_map: Dict[str, int] = {}
    free = list(range(num_vregs))
    active: List[Tuple[int, str]] = []         # (end, vname)
    peak = 0
    for name, (start, end) in sorted(intervals.items(), key=lambda kv: kv[1][0]):
        live = []
        for e, n in active:
            if e >= start:
                live.append((e, n))
            else:
                free.append(reg_map[n])
        active = live
        if not free:
            raise RuntimeError(f"NVU register file exhausted ({num_vregs})")
        reg_map[name] = free.pop(0)
        active.append((end, name))
        peak = max(peak, len(active))
    return reg_map, peak


def nvu_microprogram(routine: str, hw: NPEHardware) -> NVUMicroprogram:
    """Expand a routine into VLIW bundles with allocated vector registers."""
    passes = ROUTINE_PASSES[routine]
    lanes_log = int(math.log2(max(hw.lanes(16), 2)))
    per_pass_ops = [_pass_micro_ops(p, i) for i, p in enumerate(passes)]
    reg_map, peak = _linear_scan(per_pass_ops, hw.num_vregs)
    micro_passes = tuple(
        PassMicro(bundles=_bundle(ops, hw),
                  reduce_tail=lanes_log if p.reduce_tail else 0,
                  scalar=p.scalar)
        for p, ops in zip(passes, per_pass_ops))
    # double-buffered chunk pipelining: how many chunks fit in flight
    unroll = max(1, hw.num_vregs // max(peak, 1))
    return NVUMicroprogram(routine, micro_passes, reg_map, peak, unroll)


# ---------------------------------------------------------------------------
# Lowered program
# ---------------------------------------------------------------------------

@dataclass
class LoweredInstr:
    unit: str
    op: str
    cycles: int
    deps: Tuple[int, ...]          # indices into CompiledProgram.instrs
    tag: str
    shape: Tuple[int, ...]
    node: int                      # producing IR node id
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CompiledProgram:
    graph: Graph
    hw: NPEHardware
    bits: int
    nvu_source: str
    instrs: List[LoweredInstr]
    node_to_instr: Dict[int, int]
    # schedule memo (keyed by overlap flag, or "stream" for the
    # tile-streaming model) — issue_order() and callers asking for stats
    # share one scheduling pass
    sched_cache: Dict[Any, Dict] = field(default_factory=dict)

    def to_overlay(self) -> Program:
        """Project onto the core overlay ISA (program order = emission
        order) for the existing earliest-start list scheduler."""
        p = Program()
        for ins in self.instrs:
            p.add(Instr(ins.unit, ins.op, ins.cycles, ins.deps, ins.tag,
                        ins.shape))
        return p

    def counts_by_unit(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ins in self.instrs:
            out[ins.unit] = out.get(ins.unit, 0) + 1
        return out

    def busy_by_unit(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ins in self.instrs:
            out[ins.unit] = out.get(ins.unit, 0) + ins.cycles
        return out

    def mmu_tiling_summary(self) -> Dict[str, Any]:
        """Aggregate MMU tiling efficiency: tiled (charged) vs ideal
        (MAC-rate floor) cycles, plus how many matmuls are *skinny* (fewer
        output rows than the 128 PE rows — every projection in a decode
        step) and the worst single-matmul efficiency among them.

        Invariant (ragged-tile charging): every MMU instruction charges
        exactly the sum of its per-tile slices — slices x slice_cycles ==
        tiled_cycles == the instruction's scheduled cost.  Tensor-parallel
        shard streams (repro.npec.fleet.partition_tensor) re-tile their
        carved matmuls through `shard_tile`, so the same invariant covers
        them; `sharded_matmuls` counts how many carry shard metadata."""
        ideal = tiled = skinny = sharded = 0
        worst = 1.0
        for ins in self.instrs:
            if ins.unit != "MMU":
                continue
            t = ins.meta["tiling"]
            s = ins.meta["stream"]
            assert (s["slices"] * s["slice_cycles"] == t["tiled_cycles"]
                    == ins.cycles), (
                ins.tag, "per-tile charges drifted from the charged cost")
            ideal += t["ideal_cycles"]
            tiled += t["tiled_cycles"]
            if "shard" in ins.meta:
                sharded += 1
            if ins.shape[0] < self.hw.mmu_pes:
                skinny += 1
                worst = min(worst, t["efficiency"])
        return dict(ideal_cycles=ideal, tiled_cycles=tiled,
                    efficiency=(ideal / tiled) if tiled else 1.0,
                    skinny_matmuls=skinny, worst_skinny_efficiency=worst,
                    sharded_matmuls=sharded)


def make_transfer(unit: str, rows: int, deps: Tuple[int, ...],
                  tag: str) -> LoweredInstr:
    """Inter-overlay transfer instruction for sharded streams
    (repro.npec.fleet): activation rows leaving an overlay are an MWU
    "send", rows landing on one an MRU "recv", both charged at the
    traffic units' 1-row-per-cycle convention — the same rate MoE
    dispatch/combine already charge on a single overlay.  The instruction
    carries ``meta["xfer"] = True`` so fleet reports can itemize transfer
    cycles instead of folding them into compute
    (repro.npec.schedule.transfer_cycles)."""
    if unit not in ("MRU", "MWU"):
        raise ValueError(f"transfers ride the traffic units, got {unit!r}")
    rows = int(rows)
    op = "recv" if unit == "MRU" else "send"
    return LoweredInstr(unit, op, rows, tuple(deps), tag, (rows,),
                        node=-1, meta=dict(rows=rows, xfer=True))


def _prod(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def lower(graph: Graph, hw: NPEHardware, bits: int = 16,
          nvu_source: str = "paper") -> CompiledProgram:
    """Lower an IR graph to an overlay instruction stream."""
    instrs: List[LoweredInstr] = []
    node_to_instr: Dict[int, int] = {}
    # deps of a node = instruction indices its value transitively needs
    node_deps: Dict[int, Tuple[int, ...]] = {}
    micro_cache: Dict[str, NVUMicroprogram] = {}

    def deps_of(node: Node) -> Tuple[int, ...]:
        s: List[int] = []
        for i in node.inputs:
            for d in node_deps[i]:
                if d not in s:
                    s.append(d)
        return tuple(s)

    for node in graph.nodes:
        deps = deps_of(node)
        if node.op == "matmul":
            a = graph.node(node.inputs[0])
            n, k = a.shape[-2], a.shape[-1]
            m = node.shape[-1]
            weight_resident = graph.node(node.inputs[1]).op == "param"
            idx = len(instrs)
            tiling = tile_matmul(hw, n, k, m, bits)
            instrs.append(LoweredInstr(
                "MMU", "matmul", tiling["tiled_cycles"], deps,
                node.tag, (n, k, m), node.id,
                meta=dict(tiling=tiling, stream=tile_stream(tiling),
                          weight_resident=weight_resident)))
            node_to_instr[node.id] = idx
            node_deps[node.id] = (idx,)
        elif node.op in NVU_ROUTINE_FOR:
            routine = NVU_ROUTINE_FOR[node.op]
            if routine not in micro_cache:
                micro_cache[routine] = nvu_microprogram(routine, hw)
            micro = micro_cache[routine]
            n_el = _prod(node.shape)
            model_cycles = micro.cycles(hw, n_el)
            assert model_cycles == nvu_cycles(hw, routine, n_el, "model"), (
                routine, "VLIW bundling drifted from the overlay cost model")
            idx = len(instrs)
            charged = nvu_cycles(hw, routine, n_el, nvu_source)
            instrs.append(LoweredInstr(
                "NVU", routine, charged,
                deps, node.tag, (n_el,), node.id,
                meta=dict(ir_op=node.op,
                          bundles_per_chunk=[len(p.bundles)
                                             for p in micro.passes],
                          vregs_used=micro.regs_used,
                          unroll=micro.unroll,
                          consume=nvu_consume(hw, charged, n_el),
                          model_cycles=model_cycles)))
            node_to_instr[node.id] = idx
            node_deps[node.id] = (idx,)
        elif node.op == "topk":
            if node.attrs["out"] == "indices":
                # produced by the values node's NVU pass — folds onto it
                node_deps[node.id] = deps
                continue
            # k max-select passes over the probability rows, each at the
            # elementwise PWL-class (gelu) rate: load, vector max-compare
            # chain, store — the NVU has no sorter, so top-k is k sweeps
            n_el = _prod(graph.node(node.inputs[0]).shape)
            k = node.attrs["k"]
            cycles = k * nvu_cycles(hw, "gelu", n_el, nvu_source)
            idx = len(instrs)
            instrs.append(LoweredInstr(
                "NVU", "topk", cycles, deps, node.tag, (n_el,), node.id,
                meta=dict(ir_op="topk", k=k, routine="gelu",
                          consume=nvu_consume(hw, cycles, n_el),
                          passes=k)))
            node_to_instr[node.id] = idx
            node_deps[node.id] = (idx,)
        elif node.op == "scatter_slot":
            # MWU scatter: every one of the S*k token-slots writes its
            # D-element row into the expert-slot buffer (or drops) — one
            # row per cycle of write traffic
            s = graph.node(node.inputs[0]).shape[-2]
            rows = s * node.attrs["top_k"]
            idx = len(instrs)
            instrs.append(LoweredInstr(
                "MWU", "scatter", rows, deps, node.tag, node.shape,
                node.id, meta=dict(rows=rows,
                                   capacity=node.attrs["capacity"],
                                   num_experts=node.attrs["num_experts"])))
            node_to_instr[node.id] = idx
            node_deps[node.id] = (idx,)
        elif node.op == "gather":
            # MRU gather: expert mode reads the expert's C slot rows;
            # combine mode reads each surviving token-slot's output row
            if node.attrs["mode"] == "expert":
                rows = node.shape[-2]
            else:
                rows = node.shape[-2] * node.attrs["top_k"]
            idx = len(instrs)
            instrs.append(LoweredInstr(
                "MRU", "gather", rows, deps, node.tag, node.shape,
                node.id, meta=dict(rows=rows, mode=node.attrs["mode"])))
            node_to_instr[node.id] = idx
            node_deps[node.id] = (idx,)
        else:
            # structural: folds into producer epilogues / MRU-MWU traffic
            node_deps[node.id] = deps
    return CompiledProgram(graph, hw, bits, nvu_source, instrs,
                           node_to_instr)

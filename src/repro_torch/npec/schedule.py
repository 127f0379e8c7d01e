"""Instruction scheduling for compiled overlay programs.

A copy of `repro/npec/schedule.py` in the port, which imports nothing of the reference
package; the cycle figures are the FPGA overlay model's, never a GPU's.

`greedy_schedule` is a greedy earliest-start list scheduler over the
per-unit timelines (MMU, NVU, ...): at every step it issues, among the
ready instructions (all dependencies scheduled), the one that can *start*
earliest; ties fall to cross-unit feeders (instructions whose consumers
run on a different unit — issuing QK^T ahead of the next head's
projections is what keeps the NVU fed), then to the larger critical path
(longest cycle-weighted path to a sink — which defers the AV matmuls past
later heads' projections), then to emission order.  Because the tracer
emits heads in plain dataflow order (q,k,v,qk,softmax,av), the paper's
softmax/matmul overlap (§7.2.1) is not hand-placed anywhere — the
scheduler discovers it from the dependency structure and these two
tie-breaks, reproducing the hand-built §7.2.1 issue order exactly
(tests/test_npec.py sweeps all NVU widths x sequence lengths x MMU
precisions).

`issue_order` freezes that schedule back into an overlay `Program` whose
program order IS the issue order, so the existing in-order earliest-start
scheduler in `repro.core.cycles.schedule` reproduces the same timeline —
that cross-check runs in tests/test_npec.py.

`stream_schedule` refines the same greedy loop to TILE granularity — the
paper's own latency model (§7.2.1, Table 4).  Every lowered matmul
carries its per-tile cycle slices (`meta["stream"]`, from
`lower.tile_matmul`) and every NVU instruction a rate-matched consumption
profile (`meta["consume"]`), so a nonlinearity may *start* once its
producer's first tile lands and must *finish* no earlier than one
consumer chunk after the producer's last tile:

    start >= producer_start + first_tile_slice     (chunked earliest start)
    end    = max(start + own_cycles, producer_end + tail_chunk)

This is the fluid tile-stream abstraction behind the paper's budget
analysis: a layernorm streams concurrently with the matmul feeding it and
stalls the machine only by max(0, nvu_cycles - producer_cycles) — the
per-stall budgets `stream_schedule` reports (`stalls`: ln_a, ln_b, gelu,
softmax, ...) in the same shape as
`core.cycles.inference_cycles_streaming`, which it must match within 2%
(tests/test_npec_stream.py sweeps NVU widths x seq {64,128,256} x MMU
precisions).  Matmuls still wait for their producers to complete (the B
operand must be fully resident before the contraction can stream), so
`greedy_schedule` remains the whole-op DAG ablation:
dag >= streaming >= mmu_busy.

One known, deliberate divergence: in NVU-saturated configs at seq 512
the compiled schedule comes in up to ~3% UNDER the analytic model,
because the paper charges every head's softmax stall against a budget of
only the next head's projections + QK^T, while the real pipeline also
back-fills ready AV matmuls under pending softmaxes — the scheduler
finds overlap the paper's conservative budget ignores.  The conformance
sweep therefore gates seq <= 256 (where the two models agree within
~1.3%) and gates seq 512 with the dag >= streaming >= mmu_busy
invariants instead.

Decode streams (repro.npec.trace.trace_decode) schedule through the same
machinery: the pos-masked softmaxes overlap the next kv group's skinny
projections exactly as prefill softmax overlaps the next head's — the
per-step cost behind core.cycles.autoregressive_cycles and the serving
engine (repro.npec.runtime, `cycle_model="streaming"`).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.overlay import Instr, Program
from repro_torch.npec.lower import CompiledProgram, LoweredInstr


def _serialize_nvu(instrs: List[LoweredInstr]) -> List[LoweredInstr]:
    """No-overlap ablation (paper Table 2's pessimistic model): every
    instruction additionally depends on the last NVU instruction emitted
    before it, so no matmul may start under a pending nonlinearity.

    Issued in emission order (no greedy reordering) this is *strictly*
    serial — the schedule totals exactly the per-unit busy sums.  The
    hand-built builder's overlap=False variant retains a small accidental
    overlap (its deferred AV matmuls run under the last head's softmax),
    so the compiled ablation is the tighter upper bound: hand <= npec,
    within ~2.5% (asserted in tests/test_npec.py)."""
    out: List[LoweredInstr] = []
    last_nvu = None
    for i, ins in enumerate(instrs):
        deps = ins.deps
        if last_nvu is not None and last_nvu not in deps:
            deps = deps + (last_nvu,)
        out.append(LoweredInstr(ins.unit, ins.op, ins.cycles, deps, ins.tag,
                                ins.shape, ins.node, ins.meta))
        if ins.unit == "NVU":
            last_nvu = i
    return out


def greedy_schedule(compiled: CompiledProgram, *, overlap: bool = True) -> Dict:
    """List-schedule the compiled program; returns the timeline summary
    (same keys as repro.core.cycles.schedule) plus the issue order and
    per-instruction start/end times.  overlap=False serializes every
    nonlinearity against all later instructions and issues in emission
    order — the strictly-serial Table 2 ablation (no greedy reordering,
    which would back-fill the NVU stalls with ready AV matmuls and defeat
    the ablation's purpose).  Results are memoized on the program."""
    cached = compiled.sched_cache.get(overlap)
    if cached is not None:
        return cached
    instrs = compiled.instrs if overlap else _serialize_nvu(compiled.instrs)
    if not overlap:
        sched = _inorder_schedule(compiled, instrs)
        compiled.sched_cache[overlap] = sched
        return sched
    n = len(instrs)
    remaining = [len(ins.deps) for ins in instrs]
    consumers: List[List[int]] = [[] for _ in range(n)]
    for i, ins in enumerate(instrs):
        for d in ins.deps:
            consumers[d].append(i)
    # critical path: longest cycle-weighted path from each instr to a sink
    cp = [0.0] * n
    for i in range(n - 1, -1, -1):
        cp[i] = instrs[i].cycles + max((cp[c] for c in consumers[i]),
                                       default=0.0)
    # does retiring this instr unblock work on another unit?
    cross = [any(instrs[c].unit != instrs[i].unit for c in consumers[i])
             for i in range(n)]
    ready = [i for i in range(n) if remaining[i] == 0]
    free: Dict[str, float] = {}
    start = [0.0] * n
    end = [0.0] * n
    order: List[int] = []
    scheduled = [False] * n
    while ready:
        best, best_key = None, None
        for i in ready:
            ins = instrs[i]
            s = max(free.get(ins.unit, 0.0),
                    max((end[d] for d in ins.deps), default=0.0))
            key = (s, not cross[i], -cp[i], i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        best_start = best_key[0]
        ready.remove(best)
        ins = instrs[best]
        start[best] = best_start
        end[best] = best_start + ins.cycles
        free[ins.unit] = end[best]
        scheduled[best] = True
        order.append(best)
        for c in consumers[best]:
            remaining[c] -= 1
            if remaining[c] == 0:
                ready.append(c)
    assert all(scheduled), "dependency cycle in compiled program"
    total = max(end) if end else 0.0
    busy = compiled.busy_by_unit()
    sched = {
        "total_cycles": total,
        "mmu_busy": float(busy.get("MMU", 0)),
        "nvu_busy": float(busy.get("NVU", 0)),
        "mmu_util": busy.get("MMU", 0) / total if total else 0.0,
        "order": order,
        "start": start,
        "end": end,
    }
    compiled.sched_cache[overlap] = sched
    return sched


def _inorder_schedule(compiled: CompiledProgram,
                      instrs: List[LoweredInstr]) -> Dict:
    """Earliest-start simulation in emission order (the core in-order
    scheduler's semantics), used for the no-overlap ablation."""
    n = len(instrs)
    free: Dict[str, float] = {}
    start = [0.0] * n
    end = [0.0] * n
    for i, ins in enumerate(instrs):
        s = max(free.get(ins.unit, 0.0),
                max((end[d] for d in ins.deps), default=0.0))
        start[i], end[i] = s, s + ins.cycles
        free[ins.unit] = end[i]
    total = max(end) if end else 0.0
    busy = compiled.busy_by_unit()
    return {
        "total_cycles": total,
        "mmu_busy": float(busy.get("MMU", 0)),
        "nvu_busy": float(busy.get("NVU", 0)),
        "mmu_util": busy.get("MMU", 0) / total if total else 0.0,
        "order": list(range(n)),
        "start": start,
        "end": end,
    }


def _first_out(ins: LoweredInstr) -> float:
    """Cycles from an instruction's start until its FIRST output slice is
    available to a rate-matched consumer: one tile (MMU), one chunk (NVU),
    one row (MRU/MWU traffic streams a row per cycle)."""
    if ins.unit == "MMU":
        return float(ins.meta["stream"]["slice_cycles"])
    if ins.unit == "NVU":
        consume = ins.meta.get("consume")
        return float(consume["tail_cycles"]) if consume else float(ins.cycles)
    return 1.0


def _tail(ins: LoweredInstr) -> float:
    """Drain cycles a rate-matched consumer needs after its producer's
    last tile: one chunk of its own processing."""
    consume = ins.meta.get("consume")
    return float(consume["tail_cycles"]) if consume else float(ins.cycles)


def _stall_key(ins: LoweredInstr) -> str:
    """Bucket an NVU instruction into the stall keys the analytic
    streaming model reports: the final tag component (`enc0.ln_a` ->
    `ln_a`, `enc0.h3.softmax` -> `softmax`), with the activation tag
    normalized to its routine (`act` -> `gelu`)."""
    tail = ins.tag.rsplit(".", 1)[-1] if ins.tag else ins.op
    if tail == "act":
        return "gelu"
    return tail or ins.op


def _xfer_key(ins: LoweredInstr) -> str:
    """Stall key for an inter-overlay transfer instruction: the LEADING
    tag component names the crossing kind (`allreduce.enc0.attn.out.send`
    -> `allreduce`, `allgather.logits.recv` -> `allgather`,
    `xfer.s1.recv` -> `xfer`), so sharded streams attribute their
    communication stalls separately from the NVU budgets."""
    head = ins.tag.split(".", 1)[0] if ins.tag else ins.op
    return head or ins.op


def _xfer_blocker(instrs: List[LoweredInstr], i: int,
                  end: List[float], prev_end: float):
    """Latest-ending transfer instruction the MMU instruction `i`
    transitively waits on past `prev_end` — the all-reduce (or stage
    crossing) actually blocking it.  Only consulted when no direct NVU
    dependency explains the gap, so monolithic streams (which carry no
    ``meta["xfer"]`` instructions) schedule bit-identically."""
    seen = set()
    frontier = list(instrs[i].deps)
    best = None
    while frontier:
        d = frontier.pop()
        if d in seen:
            continue
        seen.add(d)
        if instrs[d].meta.get("xfer") and end[d] > prev_end:
            if best is None or end[d] > end[best]:
                best = d
            continue
        frontier.extend(instrs[d].deps)
    return best


def stream_schedule(compiled: CompiledProgram) -> Dict:
    """Tile-granular streaming schedule (the paper's own latency model).

    Same greedy earliest-start loop and tie-breaks as `greedy_schedule`,
    but NVU instructions pipeline under their producers: an NVU consumer
    may start once the latest-ending dependency has streamed its first
    tile slice (all *other* dependencies — residual inputs, parameters —
    must be fully complete), and it finishes at
    max(start + own_cycles, producer_end + one consumer chunk).  Matmuls
    keep whole-op dependencies (their weight/B operand must be resident).

    Returns the `greedy_schedule` summary keys plus `stalls`: per-key NVU
    stall budgets — MMU idle gaps attributed to the blocking nonlinearity
    plus the trailing NVU excess past the last matmul — in the same shape
    as `core.cycles.inference_cycles_streaming` (which the totals must
    match within 2% for BERT prefill, tests/test_npec_stream.py).
    Memoized on the program under the key ``"stream"``."""
    cached = compiled.sched_cache.get("stream")
    if cached is not None:
        return cached
    instrs = compiled.instrs
    n = len(instrs)
    remaining = [len(ins.deps) for ins in instrs]
    consumers: List[List[int]] = [[] for _ in range(n)]
    for i, ins in enumerate(instrs):
        for d in ins.deps:
            consumers[d].append(i)
    cross = [any(instrs[c].unit != instrs[i].unit for c in consumers[i])
             for i in range(n)]
    ready = [i for i in range(n) if remaining[i] == 0]
    free: Dict[str, float] = {}
    start = [0.0] * n
    end = [0.0] * n
    order: List[int] = []

    def _times(i: int) -> tuple:
        ins = instrs[i]
        unit_free = free.get(ins.unit, 0.0)
        if ins.unit == "NVU" and ins.deps:
            p = max(ins.deps, key=lambda d: end[d])
            others = max((end[d] for d in ins.deps if d != p), default=0.0)
            first = min(start[p] + _first_out(instrs[p]), end[p])
            s = max(unit_free, others, first)
            e = max(s + ins.cycles, end[p] + _tail(ins))
        else:
            s = max(unit_free, max((end[d] for d in ins.deps), default=0.0))
            e = s + ins.cycles
        return s, e

    # Tie-breaks: cross-unit feeders first (as greedy_schedule), then
    # EMISSION order — not critical path.  The ICU consumes the stream in
    # near-emission order (q,k,v,qk,softmax per head), which is exactly
    # the software pipeline the paper's §7.2.1 softmax budget assumes
    # (next head's QKV + QK^T under the pending softmax); critical-path
    # deferral of the V projections would back-fill softmax stalls beyond
    # that budget and drift from the analytic model it must match.
    while ready:
        best, best_key, best_t = None, None, None
        for i in ready:
            s, e = _times(i)
            key = (s, not cross[i], i)
            if best_key is None or key < best_key:
                best, best_key, best_t = i, key, (s, e)
        ready.remove(best)
        start[best], end[best] = best_t
        free[instrs[best].unit] = end[best]
        order.append(best)
        for c in consumers[best]:
            remaining[c] -= 1
            if remaining[c] == 0:
                ready.append(c)
    assert len(order) == n, "dependency cycle in compiled program"
    total = max(end) if end else 0.0
    busy = compiled.busy_by_unit()

    # --- per-stall budgets: MMU idle gaps + trailing NVU excess ---------
    intervals = _stall_intervals(instrs, start, end)
    stalls: Dict[str, float] = {}
    for t0, t1, key in intervals:
        stalls[key] = stalls.get(key, 0.0) + (t1 - t0)

    sched = {
        "total_cycles": total,
        "mmu_busy": float(busy.get("MMU", 0)),
        "nvu_busy": float(busy.get("NVU", 0)),
        "mmu_util": busy.get("MMU", 0) / total if total else 0.0,
        "stalls": stalls,
        "stall_intervals": intervals,
        "order": order,
        "start": start,
        "end": end,
    }
    compiled.sched_cache["stream"] = sched
    return sched


def _stall_intervals(instrs: List[LoweredInstr], start: List[float],
                     end: List[float]) -> List[tuple]:
    """Attributed stall gaps as explicit ``(t0, t1, key)`` intervals in
    stream-local cycles: MMU idle gaps attributed to the blocking NVU
    instruction, then the trailing NVU excess past the last matmul.

    This is the single source of truth for stall accounting —
    `stream_schedule` folds these intervals into its per-key ``stalls``
    budgets (same iteration order, so the float sums are bit-identical to
    the pre-refactor walk), and the observability tracer
    (repro.npec.obs) re-emits them as timeline spans, which is what lets
    traces reconcile exactly against the scheduled stall budgets.
    Intervals are non-overlapping and sorted by start within each of the
    two phases (gap walk, then trailing excess)."""
    n = len(instrs)
    intervals: List[tuple] = []
    mmu = sorted((i for i in range(n) if instrs[i].unit == "MMU"),
                 key=lambda i: start[i])
    prev_end = 0.0
    for i in mmu:
        gap = start[i] - prev_end
        if gap > 1e-9:
            blockers = [d for d in instrs[i].deps
                        if instrs[d].unit == "NVU" and end[d] > prev_end]
            if blockers:
                b = max(blockers, key=lambda d: end[d])
                intervals.append((prev_end, start[i], _stall_key(instrs[b])))
            else:
                # sharded streams: no nonlinearity explains the gap, but a
                # transfer (all-reduce / stage crossing) it waits on might
                b = _xfer_blocker(instrs, i, end, prev_end)
                if b is not None:
                    intervals.append((prev_end, start[i],
                                      _xfer_key(instrs[b])))
        prev_end = max(prev_end, end[i])
    last_mmu = max((end[i] for i in mmu), default=0.0)
    t = last_mmu
    for i in sorted(range(n), key=lambda i: end[i]):
        is_xfer = bool(instrs[i].meta.get("xfer"))
        if (instrs[i].unit != "NVU" and not is_xfer) or end[i] <= t:
            continue
        key = _xfer_key(instrs[i]) if is_xfer else _stall_key(instrs[i])
        intervals.append((max(t, start[i]), end[i], key))
        t = end[i]
    return intervals


def transfer_cycles(compiled: CompiledProgram) -> int:
    """Inter-overlay transfer traffic charged inside a sharded stream:
    the summed cycles of its `make_transfer` MRU/MWU instructions
    (repro.npec.lower, ``meta["xfer"]``).  Zero for any monolithic
    compiled program — fleet reports subtract nothing, they itemize."""
    return int(sum(ins.cycles for ins in compiled.instrs
                   if ins.meta.get("xfer")))


def schedule_for(compiled: CompiledProgram, cycle_model: str) -> Dict:
    """Dispatch a cycle-model name to its scheduler — the ONE mapping the
    cost wrappers (core.cycles) and the serving engine (npec.runtime)
    share: ``"streaming"`` -> `stream_schedule` (tile-granular, the
    serving default), ``"dag"`` -> `greedy_schedule` (whole-op)."""
    if cycle_model == "streaming":
        return stream_schedule(compiled)
    if cycle_model == "dag":
        return greedy_schedule(compiled)
    raise ValueError(f"unknown cycle model {cycle_model!r}")


def issue_order(compiled: CompiledProgram, *, overlap: bool = True) -> Program:
    """Reorder the compiled stream into its greedy issue order and project
    onto the overlay ISA; program order then equals issue order, which is
    how the ICU actually consumes the stream."""
    instrs = (compiled.instrs if overlap
              else _serialize_nvu(compiled.instrs))
    sched = greedy_schedule(compiled, overlap=overlap)
    pos = {old: new for new, old in enumerate(sched["order"])}
    p = Program()
    for old in sched["order"]:
        ins = instrs[old]
        p.add(Instr(ins.unit, ins.op, ins.cycles,
                    tuple(sorted(pos[d] for d in ins.deps)),
                    ins.tag, ins.shape))
    return p

"""NPE cycle-level performance model (paper §5.5, §7, §8).

A copy of `repro/core/cycles.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Builds the overlay instruction DAG for a BERT-class encoder stack and
schedules it on the two compute resources (MMU, NVU) with a greedy
earliest-start list scheduler.  Softmax/matmul overlap (paper §7.2.1) is
*not* hard-coded: it emerges from the dependency structure — softmax for
head i depends only on QK_i, while V_i and head i+1's projections are
independent and keep the MMU busy.

Outputs reproduce:
  * Table 2  — throughput requirements (throughput_requirements)
  * Table 4  — overlap-relaxed requirements (optimized_requirements)
  * Fig 5    — % latency overhead vs NVU-2048 (inference_cycles sweep)
  * Fig 6    — absolute latency (inference_time_ms)
  * Table 7  — inferences/sec (throughput_inf_s)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.overlay import (Instr, NPEHardware, Program, mmu_cycles,
                                mmu_tiled_cycles, nvu_cycles,
                                paper_nvu_throughput)


# ---------------------------------------------------------------------------
# BERT encoder program builder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BertShape:
    seq: int = 512
    hidden: int = 768
    heads: int = 12
    d_ff: int = 3072
    encoders: int = 12

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def build_encoder_program(hw: NPEHardware, shape: BertShape, bits: int,
                          nvu_source: str = "paper",
                          overlap: bool = True,
                          backend: str = "hand") -> Program:
    """One encoder's instruction DAG (computation of paper Table 1).

    With overlap=False, every nonlinearity serializes against all later
    matmuls (the pessimistic Table 2 model); with True, only true data
    dependencies constrain the schedule.

    backend="hand" is the original hand-built builder (kept as the golden
    cross-check); backend="npec" traces the same encoder through the NPE
    compiler (repro_torch.npec) and returns its issue-ordered overlay program —
    the path every other model family uses.  Both backends charge matmuls
    at the padded tile rate (`mmu_tiled_cycles`) — what the 128-PE-row
    geometry actually executes — so the cross-check compares like for
    like; for MMU-aligned shapes (seq >= 128, BERT dims) this equals the
    ideal MAC rate.
    """
    if backend == "npec":
        from repro_torch import npec
        compiled = npec.compile_bert_shape(hw, shape, bits,
                                           nvu_source=nvu_source, layers=1)
        return npec.issue_order(compiled, overlap=overlap)
    if backend != "hand":
        raise ValueError(f"unknown backend {backend!r}")
    S, H, A, F = shape.seq, shape.hidden, shape.heads, shape.d_ff
    hd = shape.head_dim
    p = Program()
    last_barrier: Tuple[int, ...] = ()

    def mm(tag, n, k, m, deps):
        return p.add(Instr("MMU", "matmul",
                           mmu_tiled_cycles(hw, n, k, m, bits),
                           tuple(deps), tag, (n, k, m)))

    def nvu(tag, routine, n_el, deps):
        return p.add(Instr("NVU", routine, nvu_cycles(hw, routine, n_el, nvu_source),
                           tuple(deps), tag, (n_el,)))

    # --- multi-headed self-attention ---
    # Both units issue in program order (the ICU streams instructions), so
    # the paper's softmax/matmul overlap (§7.2.1) is expressed as *software
    # pipelining*: all heads' projections + QK^T + softmax are emitted
    # first — the MMU works through head i+1's projections while the NVU
    # processes softmax_i — and the AV matmuls are emitted afterwards.
    z_heads: List[int] = []
    sms: List[Tuple[int, int]] = []
    prev_serial: Tuple[int, ...] = ()
    for i in range(A):
        q = mm(f"h{i}.q", S, H, hd, prev_serial)
        k = mm(f"h{i}.k", S, H, hd, prev_serial)
        v = mm(f"h{i}.v", S, H, hd, prev_serial)
        qk = mm(f"h{i}.qk", S, hd, S, (q, k))
        sm = nvu(f"h{i}.softmax", "softmax", S * S, (qk,))
        sms.append((sm, v))
        if not overlap:
            # serialize: nothing may start before softmax finishes
            prev_serial = (sm,)
    for i, (sm, v) in enumerate(sms):
        z_heads.append(mm(f"h{i}.av", S, S, hd, (sm, v)))
    proj = mm("attn.out", S, H, H, tuple(z_heads))
    ln_a = nvu("ln_a", "layernorm", S * H, (proj,))

    # --- feed-forward ---
    ff1 = mm("ff1", S, H, F, (ln_a,))
    gelu = nvu("gelu", "gelu", S * F, (ff1,))
    ff2 = mm("ff2", S, F, H, (gelu,))
    ln_b = nvu("ln_b", "layernorm", S * H, (ff2,))
    return p


# ---------------------------------------------------------------------------
# Two-resource list scheduler
# ---------------------------------------------------------------------------

def schedule(p: Program) -> Dict[str, float]:
    """Greedy earliest-start schedule on {MMU, NVU} resource timelines.

    Within a resource, instructions run in program order but may start as
    soon as both (a) the resource is free and (b) dependencies completed —
    this models the ICU issuing to independent pipelined units.  Tile-level
    pipelining between a matmul and its consuming nonlinearity is modeled by
    allowing the consumer to *finish* at most max(own_len, producer_end +
    epsilon-tail) — we use the conservative whole-op granularity, matching
    the paper's own budget analysis.
    """
    n = len(p.instrs)
    end = [0.0] * n
    free = {"MMU": 0.0, "NVU": 0.0, "MRU": 0.0, "MWU": 0.0}
    for idx, ins in enumerate(p.instrs):
        ready = max((end[d] for d in ins.deps), default=0.0)
        start = max(ready, free[ins.unit])
        end[idx] = start + ins.cycles
        free[ins.unit] = end[idx]
    total = max(end) if end else 0.0
    busy: Dict[str, float] = {}
    for ins in p.instrs:
        busy[ins.unit] = busy.get(ins.unit, 0.0) + ins.cycles
    return {"total_cycles": total,
            "mmu_busy": busy.get("MMU", 0.0),
            "nvu_busy": busy.get("NVU", 0.0),
            "mmu_util": busy.get("MMU", 0.0) / total if total else 0.0}


def inference_cycles_streaming(hw: NPEHardware, shape: BertShape, bits: int,
                               nvu_source: str = "paper",
                               charge: str = "ideal") -> Dict[str, float]:
    """Tile-streaming cycle model — the paper's own latency model.

    Each rate-matched nonlinearity (layernorm, GELU) streams tiles
    concurrently with its *producing* matmul, so its region costs
    max(mm_cycles, nvu_cycles); softmax overlaps the *following* independent
    matmuls (head i+1's QKV + QK^T, paper §7.2.1), so it stalls only by
    max(0, nvu - overlap_budget).  Validated against paper Fig 5 (<1% /
    ~10% / ~30% / 53% / 97% overhead points) and Table 7 (73.69 & 135.14
    inf/s at seq 64) — see tests/test_cycles.py.

    `charge="ideal"` (default) budgets matmuls at the paper's ideal MAC
    rate; `charge="padded"` budgets them at the padded tile rate
    (`mmu_tiled_cycles`, per-head) — the mode that matches what compiled
    streams charge, used by the `backend="npec"` cross-check
    (tests/test_npec_stream.py).  The two agree except where BERT shapes
    go ragged against the 128 PE rows (seq 64).
    """
    S, H, A, F = shape.seq, shape.hidden, shape.heads, shape.d_ff
    hd = shape.head_dim
    mults = hw.mmu_mults(bits)
    if charge == "ideal":
        def mm_c(n, k, m):
            return n * k * m / mults
    elif charge == "padded":
        def mm_c(n, k, m):
            return float(mmu_tiled_cycles(hw, n, k, m, bits))
    else:
        raise ValueError(f"unknown charge mode {charge!r}")
    # per-head QKV/QK^T/AV so padded charging pads each head's tiles
    # exactly as the compiled per-head instruction stream does
    mm_total = (A * (3 * mm_c(S, H, hd) + mm_c(S, hd, S) + mm_c(S, S, hd))
                + mm_c(S, H, H) + mm_c(S, H, F) + mm_c(S, F, H))

    def nvu_c(routine, n):
        return nvu_cycles(hw, routine, n, nvu_source)

    ln_cycles = nvu_c("layernorm", S * H)
    stall_ln_a = max(0.0, ln_cycles - mm_c(S, H, H))
    stall_ln_b = max(0.0, ln_cycles - mm_c(S, F, H))
    stall_gelu = max(0.0, nvu_c("gelu", S * F) - mm_c(S, H, F))
    softmax_budget = 3 * mm_c(S, H, hd) + mm_c(S, hd, S)
    stall_softmax = A * max(0.0, nvu_c("softmax", S * S) - softmax_budget)
    enc = mm_total + stall_ln_a + stall_ln_b + stall_gelu + stall_softmax
    nvu_busy = ln_cycles * 2 + nvu_c("gelu", S * F) + A * nvu_c("softmax", S * S)
    return {
        "total_cycles": enc * shape.encoders,
        "mmu_busy": mm_total * shape.encoders,
        "nvu_busy": nvu_busy * shape.encoders,
        "mmu_util": mm_total / enc,
        "stalls": dict(ln_a=stall_ln_a, ln_b=stall_ln_b, gelu=stall_gelu,
                       softmax=stall_softmax),
    }


def inference_cycles(hw: NPEHardware, shape: BertShape, bits: int,
                     nvu_source: str = "paper", overlap: bool = True,
                     model: str = "streaming",
                     backend: str = "hand",
                     charge: str = "ideal") -> Dict[str, float]:
    """Latency model; `model="streaming"` (paper-faithful) or `"dag"`
    (whole-op list schedule, used for the no-overlap ablation).

    Both models accept backend="npec" to source the numbers from the
    compiler instead of the hand-built BERT graph.  For the DAG model the
    compiled program agrees within 1% (tests/test_npec.py); for the
    streaming model `repro_torch.npec.stream_schedule` runs the compiled stream
    at tile granularity and agrees with the analytic
    `inference_cycles_streaming(charge="padded")` within 2% on total
    cycles and per-stall budgets (tests/test_npec_stream.py) — compiled
    streams always charge padded tile cycles, so `charge` selects the
    analytic ("hand") budget mode only.

    With overlap=False the compiled ablation is strictly serial (sum of
    unit busy cycles), a slightly tighter pessimistic bound than the hand
    builder's (~2.5%): see npec.schedule._serialize_nvu."""
    if model == "streaming" and overlap:
        if backend == "npec":
            from repro_torch import npec
            compiled = npec.compile_bert_shape(hw, shape, bits,
                                               nvu_source=nvu_source,
                                               layers=1)
            st = npec.stream_schedule(compiled)
            E = shape.encoders
            return {
                "total_cycles": st["total_cycles"] * E,
                "mmu_busy": st["mmu_busy"] * E,
                "nvu_busy": st["nvu_busy"] * E,
                "mmu_util": st["mmu_util"],
                # per-encoder, like the analytic model's stalls dict
                "stalls": dict(st["stalls"]),
            }
        if backend != "hand":
            raise ValueError(f"unknown backend {backend!r}")
        return inference_cycles_streaming(hw, shape, bits, nvu_source,
                                          charge=charge)
    enc = schedule(build_encoder_program(hw, shape, bits, nvu_source, overlap,
                                         backend=backend))
    return {k: (v * shape.encoders if isinstance(v, (int, float)) else v)
            for k, v in enc.items()}


def inference_time_ms(hw: NPEHardware, shape: BertShape, bits: int,
                      nvu_source: str = "paper") -> float:
    c = inference_cycles(hw, shape, bits, nvu_source)["total_cycles"]
    return 1e3 * c / hw.clock_hz


# ---------------------------------------------------------------------------
# Autoregressive serving (decode steps over a KV cache) — npec-compiled
# ---------------------------------------------------------------------------

def _npec_schedule(compiled, cycle_model: str) -> Dict[str, float]:
    """Schedule a compiled stream under the requested cycle model:
    `"streaming"` (tile-granular, the default the serving engine charges)
    or `"dag"` (whole-op list schedule, the ablation)."""
    from repro_torch import npec
    return npec.schedule_for(compiled, cycle_model)


def decode_step_cycles(hw: NPEHardware, shape: BertShape, cache_len: int,
                       bits: int, nvu_source: str = "paper",
                       cycle_model: str = "streaming") -> Dict[str, float]:
    """Cycles for ONE decode step with `cache_len` tokens resident (the new
    token included): skinny (1, H) projections, a (1, t) QK^T over the
    cache, pos-masked 1xt softmax, and the V reduction, compiled through
    repro_torch.npec (there is no hand-built decode program — the compiler IS the
    source).  One layer is compiled and scaled by `shape.encoders`
    (per-layer decode streams are identical; like the prefill tables, the
    dims-only path has no embedding/logit head).  Matmuls charge padded
    tile cycles — the 1-row projections pay the 128-PE-row geometry's
    real cost (`mmu_efficiency` reports the occupancy) — and
    `cycle_model` selects tile-streaming (default) or whole-op DAG
    scheduling."""
    from repro_torch import npec
    compiled = npec.compile_decode_bert_shape(hw, shape, cache_len, bits,
                                              nvu_source=nvu_source,
                                              layers=1)
    stats = _npec_schedule(compiled, cycle_model)
    tiling = compiled.mmu_tiling_summary()
    return {
        "total_cycles": stats["total_cycles"] * shape.encoders,
        "mmu_busy": stats["mmu_busy"] * shape.encoders,
        "nvu_busy": stats["nvu_busy"] * shape.encoders,
        "mmu_util": stats["mmu_util"],
        "mmu_efficiency": tiling["efficiency"],
    }


def batched_decode_step_cycles(hw: NPEHardware, shape: BertShape,
                               cache_len: int, batch: int, bits: int,
                               nvu_source: str = "paper",
                               cycle_model: str = "streaming",
                               window: bool = False
                               ) -> Dict[str, float]:
    """Cycles for ONE *batched* decode step: `batch` serving slots share a
    single compiled stream (repro_torch.npec.trace, `trace_decode(batch=B)`), so
    every weight projection is a merged B-row MMU tile and the PE-row
    occupancy rises toward B/128 (`mmu_efficiency`) from the ~1/128 a
    per-sequence stream sustains.  One layer is compiled and scaled by
    `shape.encoders`, like `decode_step_cycles`.

    Matmuls charge padded tile cycles, so `total_cycles` IS the sustained
    rate the geometry pays (the former ideal-rate/sustained split is
    retired with ragged-tile charging) and batching's real win shows
    directly: `cycles_per_token` falls toward the aligned rate as B-row
    tiles fill PE rows, so `tok_s` grows ~linearly in B.  `dag_cycles`
    and `streaming_cycles` report both cycle models; `total_cycles`
    follows `cycle_model` (streaming by default — what the serving engine
    charges).  `ideal_step_cycles` keeps the paper's MAC-rate floor for
    reference (flat cycles/token in B).  `window=True` compiles the ring
    (sliding-window) variant: the QK^T tile stays banded at `cache_len`
    keys forever — the bucket that never grows (docs/serving.md)."""
    from repro_torch import npec
    compiled = npec.compile_decode_bert_shape(hw, shape, cache_len, bits,
                                              nvu_source=nvu_source,
                                              layers=1, batch=batch,
                                              window=window)
    dag = npec.greedy_schedule(compiled)["total_cycles"] * shape.encoders
    stream = npec.stream_schedule(compiled)["total_cycles"] * shape.encoders
    stats = _npec_schedule(compiled, cycle_model)
    tiling = compiled.mmu_tiling_summary()
    total = stats["total_cycles"] * shape.encoders
    padding = (tiling["tiled_cycles"] - tiling["ideal_cycles"]) \
        * shape.encoders
    return {
        "total_cycles": total,
        "dag_cycles": dag,
        "streaming_cycles": stream,
        "ideal_step_cycles": total - padding,
        "cycles_per_token": total / batch,
        "tok_s": batch * hw.clock_hz / total if total else 0.0,
        "mmu_util": stats["mmu_util"],
        "mmu_efficiency": tiling["efficiency"],
    }


def chunked_prefill_cycles(hw: NPEHardware, shape: BertShape, seq: int,
                           chunk: int, bits: int,
                           nvu_source: str = "paper",
                           cycle_model: str = "streaming",
                           capacity: Optional[int] = None
                           ) -> Dict[str, float]:
    """Cycles for a `seq`-token prefill streamed as ceil(seq/chunk) causal
    cache slices over a `capacity`-row bank (default: seq rounded up to
    the chunk grid) — the per-chunk stall bound behind the serving
    engine's `prefill_chunk` mode (docs/serving.md).  One layer is
    compiled per distinct slice width and scaled by `shape.encoders`,
    like `decode_step_cycles`.  `max_slice_cycles` is the largest single
    slice's scheduled cycles: the most a chunked admit can ever stall a
    decode step, vs `whole_cycles` (the monolithic prefill stream's
    total) for an unchunked admit."""
    from repro_torch import npec
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
    cap = capacity if capacity is not None else -(-seq // chunk) * chunk
    if cap < seq:
        raise ValueError(f"capacity {cap} cannot hold a {seq}-token prompt")
    slice_cycles = []
    per_rows: Dict[int, float] = {}
    for b in range(0, seq, chunk):
        rows = min(chunk, seq - b)
        if rows not in per_rows:
            compiled = npec.compile_prefill_slice_shape(
                hw, shape, cap, rows, bits, nvu_source=nvu_source,
                layers=1)
            per_rows[rows] = _npec_schedule(compiled, cycle_model)[
                "total_cycles"] * shape.encoders
        slice_cycles.append(per_rows[rows])
    whole = npec.compile_bert_shape(hw, dataclasses.replace(shape, seq=seq),
                                    bits, nvu_source=nvu_source, layers=1)
    whole_cycles = _npec_schedule(whole, cycle_model)["total_cycles"] \
        * shape.encoders
    total = sum(slice_cycles)
    return {
        "total_cycles": total,
        "whole_cycles": whole_cycles,
        "max_slice_cycles": max(slice_cycles),
        "slices": len(slice_cycles),
        "overhead": total / whole_cycles if whole_cycles else 0.0,
        "stall_reduction": (whole_cycles / max(slice_cycles)
                            if slice_cycles and max(slice_cycles)
                            else 0.0),
    }


def autoregressive_cycles(hw: NPEHardware, shape: BertShape, new_tokens: int,
                          bits: int, nvu_source: str = "paper",
                          cycle_model: str = "streaming") -> Dict[str, float]:
    """Prefill (`shape.seq` tokens through the encoder program) + decode
    with ONE compiled stream at cache capacity shape.seq + new_tokens —
    the deterministic execution model the overlay actually runs
    (docs/isa.md): the stream is loaded once and re-executed per token,
    so every step charges the full-capacity QK^T/softmax with `pos` only
    masking.  (A serving system that re-lowers length-specialized streams
    per bucket would land between this and `decode_step_cycles` at the
    running length.)  Both phases run compiled streams under the same
    `cycle_model` (tile-streaming by default) with padded tile charging,
    so the e2e numbers are consistent end to end.  Returns cycle totals
    and the tokens/sec numbers serving tables quote: `decode_tok_s`
    (steady-state generation rate) and `e2e_tok_s` (generated tokens over
    the full prefill+decode wall clock)."""
    prefill = inference_cycles(hw, shape, bits, nvu_source,
                               model=cycle_model,
                               backend="npec")["total_cycles"]
    step = decode_step_cycles(hw, shape, shape.seq + new_tokens, bits,
                              nvu_source, cycle_model=cycle_model)
    decode = step["total_cycles"] * new_tokens
    total = prefill + decode
    return {
        "prefill_cycles": prefill,
        "decode_cycles": decode,
        "total_cycles": total,
        "cycles_per_token": step["total_cycles"],
        "decode_tok_s": (new_tokens * hw.clock_hz / decode) if decode else 0.0,
        "e2e_tok_s": new_tokens * hw.clock_hz / total if total else 0.0,
        "mmu_efficiency": step["mmu_efficiency"],
    }


def throughput_inf_s(hw: NPEHardware, shape: BertShape, bits: int,
                     nvu_source: str = "paper") -> float:
    return 1e3 / inference_time_ms(hw, shape, bits, nvu_source)


# ---------------------------------------------------------------------------
# MoE layers — npec-compiled (there is no hand-built MoE program; like the
# decode streams, the compiler IS the source)
# ---------------------------------------------------------------------------

def moe_layer_cycles(hw: NPEHardware, cfg, seq: int, bits: int,
                     nvu_source: str = "paper") -> Dict[str, float]:
    """Cycles for one MoE *super-block* of `cfg` — `interleave - 1` dense
    layers plus one MoE layer, the repeating unit of granite (interleave=1:
    just the MoE layer) and llama4 (interleave=2: dense + MoE) — compiled
    through repro_torch.npec and list-scheduled.  Totals scale by
    num_layers / interleave (per-super-block streams are identical;
    headless dims-only path, no embedding/logit head).

    Beyond the timeline the summary reports what makes MoE streams
    different from dense ones: the expert capacity C (the tile height of
    every per-expert matmul), the MRU/MWU dispatch-traffic instruction
    counts, and the skinny-tile MMU efficiency those C-row matmuls
    actually sustain against the 128 PE rows."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name!r} is not an MoE config")
    from repro_torch import npec
    step = cfg.moe.interleave
    compiled = npec.compile_model(cfg, seq, hw, bits=bits,
                                  nvu_source=nvu_source, layers=step,
                                  include_embed=False)
    stats = npec.greedy_schedule(compiled)
    counts = compiled.counts_by_unit()
    tiling = compiled.mmu_tiling_summary()
    n_super = cfg.num_layers // step
    return {
        "super_block_cycles": stats["total_cycles"],
        "total_cycles": stats["total_cycles"] * n_super,
        "mmu_busy": stats["mmu_busy"] * n_super,
        "nvu_busy": stats["nvu_busy"] * n_super,
        "mmu_util": stats["mmu_util"],
        "mmu_efficiency": tiling["efficiency"],
        "skinny_matmuls": tiling["skinny_matmuls"],
        "capacity": npec.moe_capacity(cfg, seq),
        "counts": counts,
    }


# ---------------------------------------------------------------------------
# Fleet sharding — npec-compiled streams split across overlays
# (repro_torch.npec.fleet, docs/fleet.md)
# ---------------------------------------------------------------------------

def pipeline_stage_cycles(hw: NPEHardware, shape: BertShape,
                          cache_len: int, batch: int, bits: int,
                          stages: int, nvu_source: str = "paper",
                          cycle_model: str = "streaming"
                          ) -> Dict[str, float]:
    """Fleet cost wrapper: split the batched decode stream of a
    `shape.encoders`-layer stack into `stages` contiguous pipeline layer
    groups (repro_torch.npec.fleet.partition_pipeline) and report each stage's
    scheduled cycles.  Stage boundaries charge `batch` activation rows of
    MRU/MWU transfer (itemized in `transfer_cycles`, never folded into
    compute).  `steady_tok_s` is the saturated-pipeline rate — one
    B-token step per bottleneck-stage interval — vs the monolithic
    stream's `mono_tok_s`; the fleet simulator measures the bubbles this
    bound ignores."""
    from repro_torch import npec
    compiled = npec.compile_decode_bert_shape(hw, shape, cache_len, bits,
                                              nvu_source=nvu_source,
                                              layers=shape.encoders,
                                              batch=batch)
    from repro_torch.npec.fleet import partition_pipeline
    mono = npec.schedule_for(compiled, cycle_model)["total_cycles"]
    plan = partition_pipeline(compiled, stages, rows=batch)
    costs = [npec.schedule_for(p, cycle_model)["total_cycles"]
             for p in plan.stages]
    xfer = sum(npec.transfer_cycles(p) for p in plan.stages)
    bottleneck = max(costs)
    return {
        "stage_cycles": [int(round(c)) for c in costs],
        "sum_stage_cycles": int(round(sum(costs))),
        "mono_cycles": int(round(mono)),
        "bottleneck_cycles": int(round(bottleneck)),
        "transfer_cycles": int(xfer),
        "steady_tok_s": batch * hw.clock_hz / bottleneck,
        "mono_tok_s": batch * hw.clock_hz / mono,
    }


def expert_shard_cycles(hw: NPEHardware, cfg, seq: int, bits: int,
                        overlays: int, nvu_source: str = "paper",
                        cycle_model: str = "streaming"
                        ) -> Dict[str, float]:
    """Fleet cost wrapper: shard one compiled MoE inference stream's
    per-expert runs across `overlays`
    (repro_torch.npec.fleet.partition_expert) and report the phase-barriered
    request latency — every phase costs the max over its concurrent
    per-overlay tasks — vs the monolithic stream, with the
    dispatch/combine crossing cycles itemized."""
    from repro_torch import npec
    from repro_torch.npec.fleet import partition_expert
    compiled = npec.compile_model(cfg, seq, hw, bits=bits,
                                  nvu_source=nvu_source)
    mono = npec.schedule_for(compiled, cycle_model)["total_cycles"]
    plan = partition_expert(compiled, overlays)
    phase_cycles = [
        max(npec.schedule_for(t.prog, cycle_model)["total_cycles"]
            for t in ph.tasks) for ph in plan.phases]
    request = sum(phase_cycles)
    return {
        "phases": len(plan.phases),
        "capacity": plan.capacity,
        "request_cycles": int(round(request)),
        "mono_cycles": int(round(mono)),
        "transfer_cycles": int(plan.transfer_rows),
        "speedup": mono / request if request else 0.0,
    }


# ---------------------------------------------------------------------------
# Analytic tables (2 and 4)
# ---------------------------------------------------------------------------

def throughput_requirements(hw: NPEHardware, shape: BertShape,
                            bits: int = 16) -> Dict[str, Dict[str, float]]:
    """Paper Table 2: worst-case (serial) throughput requirements."""
    S, H, A, F = shape.seq, shape.hidden, shape.heads, shape.d_ff
    hd = shape.head_dim
    mults = hw.mmu_mults(bits)

    def budget(n, k, m):
        return n * k * m / mults

    total = (3 * budget(S, H, H)            # QKV (all heads together)
             + A * budget(S, hd, S)         # QK^T
             + A * budget(S, S, hd)         # AV
             + budget(S, H, H)              # output proj
             + budget(S, H, F) + budget(S, F, H))
    rows = {
        "softmax": dict(N=S, M=S, budget=budget(S, hd, S),
                        elements=S * S, pct=A * budget(S, hd, S) / total),
        "layernorm_a": dict(N=S, M=H, budget=budget(S, H, H),
                            elements=S * H, pct=budget(S, H, H) / total),
        "gelu": dict(N=S, M=F, budget=budget(S, H, F),
                     elements=S * F, pct=budget(S, H, F) / total),
        "layernorm_b": dict(N=S, M=H, budget=budget(S, F, H),
                            elements=S * H, pct=budget(S, F, H) / total),
    }
    for r in rows.values():
        r["throughput"] = r["elements"] / r["budget"]
    return rows


def optimized_requirements(hw: NPEHardware, seq_lens=(64, 128, 256, 512),
                           bits: int = 16) -> Dict[int, Dict[str, float]]:
    """Paper Table 4: requirements after overlapping (paper §7.2).

    Softmax for head i overlaps the QKV projections and QK^T of head i+1,
    so its budget is 3*S*H*hd/mults + S*hd*S/mults; LayerNorm and GELU stay
    rate-matched against their producing matmuls (they block the pipeline).
    """
    out: Dict[int, Dict[str, float]] = {}
    for S in seq_lens:
        shape = BertShape(seq=S)
        H, F, hd = shape.hidden, shape.d_ff, shape.head_dim
        mults = hw.mmu_mults(bits)
        softmax_budget = (3 * S * H * hd + S * hd * S) / mults
        out[S] = {
            "softmax": (S * S) / softmax_budget,
            "layernorm_a": (S * H) / (S * H * H / mults),
            "layernorm_b": (S * H) / (S * F * H / mults),
            "gelu": (S * F) / (S * H * F / mults),
        }
    return out

"""NPEFleet: cycle-accurate multi-overlay serving simulator.

A copy of `repro/npec/fleet/sim.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

N overlays share one admission queue on a common fleet clock.  Because
every charge is a deterministic compiled-stream schedule total
(repro_torch.npec.schedule), fleet latency under load is exactly computable —
no sampling noise, bit-reproducible records — the same property Groq's
deterministic multi-chip BERT streaming exploits (PAPERS.md, "Answer
Fast").

Three sharding strategies:

  * ``replicate`` — N independent `NPEEngine`s (each its own continuous
    batching) pull from the shared queue.  The fleet event loop
    always steps the engine whose clock is earliest among those that can
    make progress (occupied slots, or an arrived request); when all are
    idle it jumps the earliest engine to the next arrival.  A fleet of 1
    is bit-equal to a lone engine (tests/test_npec_fleet.py).
  * ``pipeline`` — the model's layers are split into N contiguous stage
    groups (repro_torch.npec.fleet.partition), one overlay per stage, and the
    fleet runs N engine *groups* so every stage has work: each engine's
    stream charge is decomposed into its per-stage schedule totals and
    chained across the shared stage timelines (`start = max(group ready,
    stage free)`).  Stage boundaries charge `rows` activation transfers
    (MWU send / MRU recv inside the stage streams), and because each
    stage advances on the common fleet clock, pipeline bubbles are
    *measured* as timeline gaps, not modeled.
  * ``prefill_decode`` — prefill/decode disaggregation: the first
    `prefill_overlays` overlays run (chunked) prefill streams only, FIFO
    over the admission queue, and ship each finished request's KV cache
    to the decode side as MWU send / MRU recv rows sized from
    `Graph.kv_exports` (repro_torch.npec.fleet.partition,
    `partition_prefill_decode`); the remaining overlays run continuous
    batching exactly as ``replicate`` engines, except admission charges
    the KV recv transfer instead of a prefill — so decode steps are
    NEVER stalled by a prompt's prefill, the p99 inter-token cliff the
    chunked single-engine mode only bounds.
  * ``tensor`` — tensor parallelism (bert/dense): ONE engine's
    continuous batching drives all N overlays in lockstep.  Every stream
    charge is carved into N column shards (repro_torch.npec.fleet.partition,
    `partition_tensor`): per-overlay heads, FFN columns, and vocab
    slices, with the attention-output / FFN-down all-reduces and the
    logits all-gather charged as MWU/MRU rows inside each shard stream.
    The shards place concurrently on the shard timelines and the engine
    clock lands on the slowest shard's completion — so a single
    request's latency (not just fleet throughput) drops with N, at the
    cost of the itemized all-reduce traffic.
  * ``expert`` — MoE expert parallelism over single-pass inference
    requests (MoE decode streams are a ROADMAP open item, so the moe
    family serves compiled full-stream inferences): each request's
    stream becomes alternating home/expert phases; expert e runs on
    overlay (home + e % N) % N with dispatch/combine crossings charged
    as MRU/MWU traffic.  Homes rotate per request (rid % N) so
    concurrent requests overlap phases across the fleet.

Reports fleet-level p50/p99 end-to-end latency, queue-wait and service
percentiles, per-overlay utilization, aggregate tokens/sec, and the
itemized inter-overlay transfer cycles.  See docs/fleet.md.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.core.overlay import NPEHardware
from repro_torch.npec import (CompiledProgram, compile_decode, compile_model,
                        compile_prefill, schedule_for, transfer_cycles)
from repro_torch.npec.fleet.partition import (ExpertPlan, PipelinePlan,
                                        PrefillDecodePlan, TensorPlan,
                                        partition_expert,
                                        partition_pipeline,
                                        partition_prefill_decode,
                                        partition_tensor)
from repro_torch.npec.obs.metrics import MetricsRegistry
from repro_torch.npec.obs.tracer import NULL_TRACER
from repro_torch.npec.runtime.batch import Request
from repro_torch.npec.runtime.clock import CycleClock, LatencyTracker
from repro_torch.npec.runtime.engine import (NPEEngine, chunk_spans,
                                       synthetic_token)
from repro_torch.npec.runtime.stream_cache import StreamCache, StreamKey

SHARD_STRATEGIES = ("replicate", "expert", "pipeline", "prefill_decode",
                    "tensor")


@dataclass
class OverlayTimeline:
    """One overlay's occupancy on the fleet clock: `free` is when its
    ICU can accept the next stream, `busy` the charged stream cycles,
    `xfer` the itemized inter-overlay transfer cycles within them."""
    idx: int
    free: int = 0
    busy: int = 0
    xfer: int = 0

    def place(self, earliest: int, cycles: int, xfer: int = 0
              ) -> Tuple[int, int]:
        start = max(int(earliest), self.free)
        end = start + int(round(cycles))
        self.free = end
        self.busy += end - start
        self.xfer += int(xfer)
        return start, end


class SharedAdmissionQueue:
    """Fleet-wide FIFO with per-request arrival cycles.  Engines see it
    through `_EngineQueueView`, which gates availability on the engine's
    own clock — a request that has not arrived yet is invisible."""

    def __init__(self):
        self._q: List[Request] = []
        self._next_rid = 0
        self._popped = 0

    def submit(self, prompt, *, max_new_tokens: int,
               eos_id: Optional[int] = None,
               arrival_cycle: int = 0) -> Request:
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_id,
                      submit_cycle=int(arrival_cycle))
        self._next_rid += 1
        self._q.append(req)
        return req

    def finalize(self) -> None:
        """Order by (arrival, rid) before serving begins."""
        self._q[self._popped:] = sorted(
            self._q[self._popped:], key=lambda r: (r.submit_cycle, r.rid))

    def ready(self, now: int) -> bool:
        return (self._popped < len(self._q)
                and self._q[self._popped].submit_cycle <= now)

    def next_arrival(self) -> Optional[int]:
        if self._popped < len(self._q):
            return self._q[self._popped].submit_cycle
        return None

    def pop(self) -> Request:
        req = self._q[self._popped]
        self._popped += 1
        return req

    def __len__(self) -> int:
        return len(self._q) - self._popped


class _EngineQueueView:
    """What one engine sees of the shared queue: FIFO head if (and only
    if) it has arrived by this engine's clock."""

    def __init__(self, shared: SharedAdmissionQueue):
        self.shared = shared
        self.engine: Optional[NPEEngine] = None     # bound post-init

    def __bool__(self) -> bool:
        return self.shared.ready(self.engine.clock.cycles)

    def __len__(self) -> int:
        return len(self.shared) if bool(self) else 0

    def pop(self) -> Request:
        return self.shared.pop()


class _ReadyQueue:
    """The decode side's admission queue in a disaggregated fleet:
    duck-types `SharedAdmissionQueue` (ready/next_arrival/pop/__len__),
    but a request becomes visible at its KV-ship completion cycle — when
    its cache rows have left the prefill overlay — not at submission."""

    def __init__(self):
        self._items: List[Tuple[int, int, Request]] = []
        self._popped = 0

    def push(self, ready_cycle: int, req: Request) -> None:
        self._items.append((int(ready_cycle), req.rid, req))

    def finalize(self) -> None:
        self._items.sort(key=lambda it: it[:2])

    def ready(self, now: int) -> bool:
        return (self._popped < len(self._items)
                and self._items[self._popped][0] <= now)

    def next_arrival(self) -> Optional[int]:
        if self._popped < len(self._items):
            return self._items[self._popped][0]
        return None

    def pop(self) -> Request:
        item = self._items[self._popped]
        self._popped += 1
        return item[2]

    def __len__(self) -> int:
        return len(self._items) - self._popped


@dataclass
class FleetStats:
    """Cycle-derived fleet summary.  `tokens` counts generated tokens for
    engine-backed shards (replicate/pipeline) and processed prompt tokens
    for expert-parallel single-pass inference.

    The serving counters live in a `MetricsRegistry` (repro_torch.npec.obs):
    every engine's registry is folded in at collection time, so the fleet
    snapshot carries the per-engine counter families and cycle histograms
    too; the legacy counter names stay readable as properties."""
    overlays: int
    shard: str
    clock_hz: float
    requests: List[Request] = field(default_factory=list)
    tokens: int = 0
    makespan_cycles: int = 0
    transfer_cycles: int = 0
    busy_cycles: List[int] = field(default_factory=list)
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    stream_cache: Dict[str, int] = field(default_factory=dict)

    @property
    def decode_steps(self) -> int:
        return int(self.metrics.value("decode_steps"))

    @property
    def prefills(self) -> int:
        return int(self.metrics.value("prefills"))

    @property
    def bucket_migrations(self) -> int:
        return int(self.metrics.value("bucket_migrations"))

    @property
    def migration_cycles(self) -> int:
        return int(self.metrics.value("migration_cycles"))

    @property
    def decode_steps_by_bucket(self) -> Dict[int, int]:
        return {b: int(v) for b, v in
                self.metrics.family("decode_steps_by_bucket").items()}

    def snapshot(self) -> Dict[str, Any]:
        """Report dict plus the merged registry snapshot (serve --json)."""
        return {"report": self.report(), "metrics": self.metrics.snapshot()}

    def report(self) -> Dict[str, Any]:
        clock = CycleClock(self.clock_hz)
        e2e = LatencyTracker(clock)
        queue_wait = LatencyTracker(clock)
        service = LatencyTracker(clock)
        for r in self.requests:
            e2e.record(r.submit_cycle, r.finish_cycle)
            queue_wait.record(r.submit_cycle, r.admit_cycle)
            service.record(r.admit_cycle, r.finish_cycle)
        out: Dict[str, Any] = {
            "overlays": self.overlays,
            "shard": self.shard,
            "requests": len(self.requests),
            "tokens": self.tokens,
        }
        out.update(e2e.percentiles())
        qw = queue_wait.percentiles()
        out["queue_wait_p50_ms"] = qw["p50_ms"]
        out["queue_wait_p99_ms"] = qw["p99_ms"]
        sv = service.percentiles()
        out["service_p50_ms"] = sv["p50_ms"]
        out["service_p99_ms"] = sv["p99_ms"]
        # full precision — presentation layers round (serve.py prints,
        # paper_tables rows), so derived math never inherits print loss
        out["tokens_per_sec"] = (
            self.tokens * self.clock_hz / self.makespan_cycles
            if self.makespan_cycles else 0.0)
        out["makespan_cycles"] = self.makespan_cycles
        out["transfer_cycles"] = self.transfer_cycles
        out["overlay_util"] = [
            round(b / self.makespan_cycles, 4) if self.makespan_cycles
            else 0.0 for b in self.busy_cycles]
        out["decode_steps"] = self.decode_steps
        out["prefills"] = self.prefills
        out["decode_steps_by_bucket"] = {
            str(b): n
            for b, n in sorted(self.decode_steps_by_bucket.items())}
        out["bucket_migrations"] = self.bucket_migrations
        out["migration_cycles"] = self.migration_cycles
        out.update(self.stream_cache)
        return out


class NPEFleet:
    """N overlays + one shared admission queue on a common fleet clock."""

    def __init__(self, cfg: ModelConfig, hw: Optional[NPEHardware] = None,
                 *, overlays: int = 1, shard: str = "replicate",
                 slots: int = 4, capacity: int = 64,
                 max_new_tokens: int = 16, bits: int = 16,
                 nvu_source: str = "paper", eos_id: Optional[int] = None,
                 cycle_model: str = "streaming", seq: int = 64,
                 stream_cache: Optional[StreamCache] = None,
                 seq_buckets=None, window: Optional[int] = None,
                 inference_prog: Optional[CompiledProgram] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_overlays: int = 1, tracer=None):
        if shard not in SHARD_STRATEGIES:
            raise ValueError(f"unknown shard strategy {shard!r} "
                             f"(choose from {SHARD_STRATEGIES})")
        if overlays < 1:
            raise ValueError(f"need at least one overlay, got {overlays}")
        family = getattr(cfg, "family", None)
        if shard == "expert" and family != "moe":
            raise ValueError(
                f"expert parallelism shards per-expert runs; family "
                f"{family!r} has none (use replicate or pipeline)")
        if shard != "expert" and family == "moe":
            raise ValueError(
                "moe families serve single-pass inference via "
                "shard='expert' (MoE decode streams are a ROADMAP item)")
        if shard == "expert" and prefill_chunk is not None:
            raise ValueError("expert-parallel inference has no prefill "
                             "phase to chunk")
        if shard == "prefill_decode":
            if overlays < 2:
                raise ValueError(
                    "prefill/decode disaggregation needs at least 2 "
                    f"overlays (got {overlays})")
            if not 1 <= prefill_overlays < overlays:
                raise ValueError(
                    f"prefill_overlays must leave at least one decode "
                    f"overlay: 1 <= {prefill_overlays} < {overlays}")
        if shard == "tensor" and overlays > 1:
            for dim, what in ((cfg.num_heads, "attention head count"),
                              (cfg.num_kv_heads, "kv head count"),
                              (cfg.d_ff, "FFN width (d_ff)")):
                if dim % overlays:
                    raise ValueError(
                        f"tensor parallelism carves projections "
                        f"column-wise: {what} ({dim}) must divide evenly "
                        f"across {overlays} overlays")
        self.cfg = cfg
        self.hw = hw if hw is not None else NPEHardware()
        self.overlays = overlays
        self.shard = shard
        self.cycle_model = cycle_model
        # opt-in cycle-domain tracing (repro_torch.npec.obs): the fleet shares
        # ONE tracer with its engines; untraced runs keep the no-op
        # NULL_TRACER fast path everywhere
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.max_new_tokens = max_new_tokens
        self.seq = seq
        # ONE typed compiled-stream cache backs the whole fleet: engines
        # share decode buckets and prefill streams through it, and its
        # keys (family, kind, seq, batch, bits, nvu_source, cache_len,
        # window) make cross-engine collisions structurally impossible
        # even in heterogeneous multi-fleet setups sharing one cache
        self.stream_cache = (stream_cache if stream_cache is not None
                             else StreamCache())
        self.seq_buckets = seq_buckets
        self.window = window
        self.timelines = [OverlayTimeline(i) for i in range(overlays)]
        self.queue = SharedAdmissionQueue()
        self.stats = FleetStats(overlays=overlays, shard=shard,
                                clock_hz=self.hw.clock_hz)
        self.engines: List[NPEEngine] = []
        self._pipeline_plans: Dict[int, Tuple[CompiledProgram,
                                              PipelinePlan]] = {}
        self._tensor_plans: Dict[int, Tuple[CompiledProgram,
                                            TensorPlan]] = {}
        self.expert_plan: Optional[ExpertPlan] = None
        self.disagg_plan: Optional[PrefillDecodePlan] = None
        self.prefill_chunk = prefill_chunk
        self.prefill_overlays = (prefill_overlays
                                 if shard == "prefill_decode" else 0)

        if shard == "expert":
            if inference_prog is not None:
                self.inference_prog = inference_prog
            else:
                key = StreamKey(cfg.name, "inference", seq, 1, bits,
                                nvu_source)
                self.inference_prog = self.stream_cache.get(
                    key, lambda: compile_model(cfg, seq, self.hw,
                                               bits=bits,
                                               nvu_source=nvu_source))
            self.expert_plan = partition_expert(self.inference_prog,
                                                overlays)
            return

        self._bits = bits
        self._nvu_source = nvu_source
        self._capacity = capacity

        if shard == "prefill_decode":
            # the KV-shipping plan needs a stream with kv_exports; a
            # seq=1 serving prefill is the cheapest probe (memoized under
            # the same (seq, chunk) key a length-1 whole-prompt admit
            # would use — it IS that stream)
            self.disagg_plan = partition_prefill_decode(
                self._prefill_prog(1, chunk=None),
                prefill_overlays=prefill_overlays,
                decode_overlays=overlays - prefill_overlays)
            self._ready = _ReadyQueue()
            for g in range(overlays - prefill_overlays):
                view = _EngineQueueView(self._ready)
                eng = NPEEngine(cfg, self.hw, slots=slots,
                                capacity=capacity,
                                max_new_tokens=max_new_tokens, bits=bits,
                                nvu_source=nvu_source, eos_id=eos_id,
                                cycle_model=cycle_model,
                                stream_cache=self.stream_cache,
                                seq_buckets=seq_buckets, window=window,
                                charge_hook=self._disagg_hook,
                                queue=view, engine_id=g,
                                kv_recv=self.disagg_plan.recv_prog,
                                tracer=self.tracer)
                view.engine = eng
                # decode engine g occupies overlay prefill_overlays + g
                eng.trace_overlay = prefill_overlays + g
                self.engines.append(eng)
            return

        # replicate: one engine per overlay; pipeline: one overlay per
        # STAGE, plus N engine groups so every stage has work in flight;
        # tensor: ONE engine drives all N overlays in lockstep (each of
        # its charges is carved into N concurrent column shards).
        hook = {"replicate": self._replicate_hook,
                "pipeline": self._pipeline_hook,
                "tensor": self._tensor_hook}[shard]
        n_engines = 1 if shard == "tensor" else overlays
        for g in range(n_engines):
            view = _EngineQueueView(self.queue)
            eng = NPEEngine(cfg, self.hw, slots=slots, capacity=capacity,
                            max_new_tokens=max_new_tokens, bits=bits,
                            nvu_source=nvu_source, eos_id=eos_id,
                            cycle_model=cycle_model,
                            stream_cache=self.stream_cache,
                            seq_buckets=seq_buckets, window=window,
                            charge_hook=hook, queue=view, engine_id=g,
                            prefill_chunk=prefill_chunk,
                            tracer=self.tracer)
            view.engine = eng
            if shard == "pipeline" or (shard == "tensor" and overlays > 1):
                # stage/shard placements are traced by the hook itself
                # (one span per overlay); the engine's own whole-charge
                # emission would double-book them
                eng.trace_streams = False
            self.engines.append(eng)

    # --- request intake ------------------------------------------------

    def submit(self, prompt, *, arrival_cycle: int = 0,
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None) -> Request:
        """Queue a prompt on the fleet at `arrival_cycle` (from a seeded
        Poisson process via `SyntheticRequests.arrival_cycles`, or 0 for
        the everything-at-t0 workload)."""
        prompt = np.asarray(prompt, np.int32)
        if self.shard == "expert":
            if prompt.size != self.seq:
                raise ValueError(
                    f"expert-parallel inference streams are compiled at "
                    f"seq={self.seq}; got a {prompt.size}-token prompt")
            return self.queue.submit(
                prompt, max_new_tokens=0, eos_id=eos_id,
                arrival_cycle=arrival_cycle)
        eng = self.engines[0]
        new = (max_new_tokens if max_new_tokens is not None
               else self.max_new_tokens)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        # same boundary as NPEEngine.submit: the prefill emits the first
        # token, so the last decode append lands on row prompt + new - 2
        # and prompt + new - 1 rows must fit the bank
        if prompt.size + new - 1 > eng.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({new}) needs "
                f"{prompt.size + new - 1} cache rows and exceeds "
                f"the compiled cache capacity {eng.capacity}")
        if eng.windowed and prompt.size > eng.window:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds the ring window "
                f"{eng.window}: windowed prefill is exact only for "
                f"prompts that fit the window")
        return self.queue.submit(
            prompt, max_new_tokens=new,
            eos_id=(eos_id if eos_id is not None else eng.eos_id),
            arrival_cycle=arrival_cycle)

    # --- charge hooks (engine-backed shards) ---------------------------

    def _replicate_hook(self, engine: NPEEngine, kind: str,
                        prog: CompiledProgram, cycles: float) -> None:
        """Plain replication: the engine owns its overlay outright, so
        the charge is exactly `clock.advance` (bit-equal to a lone
        engine) mirrored onto the overlay's timeline."""
        tl = self.timelines[engine.engine_id]
        start = engine.clock.cycles
        end = engine.clock.advance(cycles)
        tl.free = end
        tl.busy += end - start

    def _disagg_hook(self, engine: NPEEngine, kind: str,
                     prog: CompiledProgram, cycles: float) -> None:
        """Decode-side charge in a disaggregated fleet: decode engine g
        owns overlay `prefill_overlays + g` outright (replicate
        semantics), and its `kv_recv` admission charges are itemized as
        transfer cycles on that overlay's timeline."""
        tl = self.timelines[self.prefill_overlays + engine.engine_id]
        start = engine.clock.cycles
        end = engine.clock.advance(cycles)
        tl.free = end
        tl.busy += end - start
        if kind == "kv_recv":
            tl.xfer += transfer_cycles(prog)

    def _prefill_prog(self, rows: int,
                      chunk: Optional[int]) -> CompiledProgram:
        """Compiled (chunked) prefill stream for `rows` prompt tokens,
        memoized in the shared stream cache under the SAME typed key an
        engine's `_prefill_program` would use — so the disagg prefill
        phase and any replicate engine of the same shape share streams,
        and differently-shaped engines can never collide."""
        cache_len = self._capacity if chunk is not None else None
        key = StreamKey(self.cfg.name,
                        "prefill_chunk" if chunk is not None
                        else "prefill",
                        rows, 1, self._bits, self._nvu_source,
                        cache_len=cache_len, window=False)
        return self.stream_cache.get(key, lambda: compile_prefill(
            self.cfg, rows, self.hw, bits=self._bits,
            nvu_source=self._nvu_source, cache_len=cache_len))

    def _stage_costs(self, prog: CompiledProgram
                     ) -> List[Tuple[CompiledProgram, float, int]]:
        """Per-stage (stage stream, scheduled cycles, transfer cycles)
        for a stream, partitioned once per compiled program."""
        key = id(prog)
        if key not in self._pipeline_plans:
            # boundary rows in flight = token rows in the stream: B slots
            # for a batched decode step, S prompt tokens for a prefill
            rows = self._stream_rows(prog)
            plan = partition_pipeline(prog, self.overlays, rows=rows)
            self._pipeline_plans[key] = (prog, plan)
        _, plan = self._pipeline_plans[key]
        return [(p, schedule_for(p, self.cycle_model)["total_cycles"],
                 transfer_cycles(p)) for p in plan.stages]

    def _stream_rows(self, prog: CompiledProgram) -> int:
        """Activation rows crossing a stage boundary: the output rows of
        the stream's first matmul (B for batched decode, S for prefill)."""
        for ins in prog.instrs:
            if ins.unit == "MMU":
                return int(ins.shape[0])
        return 1

    def _pipeline_hook(self, engine: NPEEngine, kind: str,
                       prog: CompiledProgram, cycles: float) -> None:
        """Chain the stream's stage charges across the shared stage
        overlays; the engine's clock lands on the final stage's
        completion, so its continuous batching sees end-to-end stream
        latency while the fleet keeps all stages concurrently busy."""
        tr = self.tracer
        if kind == "migrate":
            # bucket-crossing bank migration: each stage overlay moves its
            # OWN layers' banks concurrently (1 row/cycle locally), so the
            # fleet-visible cost is the per-stage share, not the chained
            # total — and no stage partition of a compute stream applies
            t0 = engine.clock.cycles
            share = cycles / max(1, len(self.timelines))
            t = t0
            for tl in self.timelines:
                start, end = tl.place(t0, share)  # local bank traffic,
                t = max(t, end)                   # not inter-overlay xfer
                if tr.enabled:
                    tr.stream(tl.idx, "migrate", prog, start, end,
                              self.cycle_model)
            # alignment to work already placed on the stage timelines —
            # busy elsewhere, not idle (docs/observability.md)
            engine.clock.advance_to(t, idle=False)
            return
        t = engine.clock.cycles
        for s, (stage_prog, c, x) in enumerate(self._stage_costs(prog)):
            start, t = self.timelines[s].place(t, c, x)
            if tr.enabled:
                tr.stream(s, kind, stage_prog, start, t, self.cycle_model)
        engine.clock.advance_to(t, idle=False)

    def _tensor_costs(self, prog: CompiledProgram
                      ) -> List[Tuple[CompiledProgram, float, int]]:
        """Per-shard (shard stream, scheduled cycles, transfer cycles)
        for a stream, carved once per compiled program."""
        key = id(prog)
        if key not in self._tensor_plans:
            plan = partition_tensor(prog, self.overlays)
            self._tensor_plans[key] = (prog, plan)
        _, plan = self._tensor_plans[key]
        return [(p, schedule_for(p, self.cycle_model)["total_cycles"],
                 transfer_cycles(p)) for p in plan.shards]

    def _tensor_hook(self, engine: NPEEngine, kind: str,
                     prog: CompiledProgram, cycles: float) -> None:
        """Place the stream's N column shards concurrently on the shard
        timelines; the engine clock lands on the slowest shard's
        completion, so its continuous batching sees the tensor-parallel
        step latency directly.  The critical-path all-reduce share is
        reported back through `engine._xfer_attr` so the engine's request
        spans can split communication from compute (docs/observability.md
        `allreduce` spans)."""
        if self.overlays == 1:
            # identity plan: bit-equal replicate semantics, fractional
            # cycle carry included (the fleet-of-1 gate)
            tl = self.timelines[0]
            start = engine.clock.cycles
            end = engine.clock.advance(cycles)
            tl.free = end
            tl.busy += end - start
            return
        tr = self.tracer
        t0 = engine.clock.cycles
        if kind == "migrate":
            # bucket-crossing bank migration: each shard overlay moves
            # its OWN heads' / columns' banks concurrently (local
            # traffic, not inter-overlay xfer)
            share = cycles / self.overlays
            t = t0
            for tl in self.timelines:
                start, end = tl.place(t0, share)
                t = max(t, end)
                if tr.enabled:
                    tr.stream(tl.idx, "migrate", prog, start, end,
                              self.cycle_model)
            engine.clock.advance_to(t, idle=False)
            return
        t = t0
        xfer_crit = 0
        for s, (shard_prog, c, x) in enumerate(self._tensor_costs(prog)):
            start, end = self.timelines[s].place(t0, c, x)
            t = max(t, end)
            xfer_crit = max(xfer_crit, int(x))
            if tr.enabled:
                tr.stream(s, kind, shard_prog, start, end,
                          self.cycle_model)
        engine._xfer_attr = min(xfer_crit, max(0, t - t0 - 1))
        engine.clock.advance_to(t, idle=False)

    # --- serving loop --------------------------------------------------

    def _event_loop(self, queue) -> None:
        """Event loop on the fleet clock: an engine with occupied slots
        can act at its own clock; an idle engine can act at the head
        request's arrival (it was free the whole wait, so its clock
        jumps forward — never back).  Always step whichever engine can
        act EARLIEST (ties to the lower overlay id), which is what
        makes a fleet of 1 bit-equal to a lone engine and keeps idle
        overlays from starving behind a busy one's advanced clock.
        `queue` is the SharedAdmissionQueue (replicate/pipeline) or the
        decode side's _ReadyQueue (prefill_decode)."""
        engines = self.engines
        while True:
            head = queue.next_arrival()
            best = None
            for e in engines:
                if len(e.pool):
                    t = e.clock.cycles
                elif head is not None:
                    t = max(e.clock.cycles, head)
                else:
                    continue
                if best is None or (t, e.engine_id) < best[:2]:
                    best = (t, e.engine_id, e)
            if best is None:
                break
            t, _, e = best
            if e.clock.cycles < t:
                e.clock.advance_to(t)
            stepped = e.step()
            assert stepped, "a ready engine must make progress"
        for e in engines:
            e.stats.total_cycles = e.clock.cycles

    def _run_engines(self) -> FleetStats:
        self.queue.finalize()
        self._event_loop(self.queue)
        engines = self.engines
        reqs = sorted((r for e in engines for r in e.stats.requests),
                      key=lambda r: r.rid)
        self.stats.requests = reqs
        self.stats.tokens = sum(len(r.generated) for r in reqs)
        self.stats.makespan_cycles = max(
            [tl.free for tl in self.timelines]
            + [e.clock.cycles for e in engines] + [0])
        self.stats.busy_cycles = [tl.busy for tl in self.timelines]
        self.stats.transfer_cycles = sum(tl.xfer for tl in self.timelines)
        self._collect_stream_stats()
        return self.stats

    def _collect_stream_stats(self) -> None:
        """Fold every engine's metrics registry (decode/prefill counters,
        bucket families, cycle histograms) and the shared stream cache's
        hit/miss totals into the fleet stats (deterministic: pure
        counters, no wall-clock)."""
        for e in self.engines:
            self.stats.metrics.merge(e.stats.metrics)
        self.stats.stream_cache = self.stream_cache.report()

    def _run_expert(self) -> FleetStats:
        self.queue.finalize()
        plan = self.expert_plan
        n = self.overlays
        tr = self.tracer
        costs = [[(t.prog,
                   schedule_for(t.prog, self.cycle_model)["total_cycles"],
                   t.xfer_rows, t.rel) for t in ph.tasks]
                 for ph in plan.phases]
        while len(self.queue):
            req = self.queue.pop()
            home = req.rid % n
            t = req.submit_cycle
            first = True
            for pi, phase in enumerate(costs):
                starts, ends, placed = [], [], 0
                for prog, cyc, xfer, rel in phase:
                    tl = self.timelines[(home + rel) % n]
                    s, e = tl.place(t, cyc, xfer)
                    if first:
                        req.admit_cycle = s
                        first = False
                        if tr.enabled:
                            tr.request_admitted(req, home)
                    if tr.enabled:
                        tr.stream(tl.idx, "expert", prog, s, e,
                                  self.cycle_model)
                    starts.append(s)
                    ends.append(e)
                    placed += e - s
                t = max(ends)
                if tr.enabled:
                    # an expert phase fans its tasks across overlays in
                    # parallel: the request span covers [min start, max
                    # end] (clipped to the admit cycle so it never
                    # overlaps the queue span) but is CHARGED the sum of
                    # the placed task lengths so attributions reconcile
                    # with busy_cycles
                    tr.req_span(req.rid, "expert_phase",
                                max(min(starts), req.admit_cycle), t,
                                home, attributed=placed, phase=pi,
                                tasks=len(phase))
            req.finish_cycle = t
            if tr.enabled:
                tr.instant(req.rid, "evict", t)
            self.stats.requests.append(req)
        self.stats.tokens = sum(len(r.prompt) for r in self.stats.requests)
        self.stats.makespan_cycles = max(
            [tl.free for tl in self.timelines] + [0])
        self.stats.busy_cycles = [tl.busy for tl in self.timelines]
        self.stats.transfer_cycles = sum(tl.xfer for tl in self.timelines)
        self.stats.stream_cache = self.stream_cache.report()
        return self.stats

    def _run_prefill_decode(self) -> FleetStats:
        """Disaggregated serve: phase 1 places every request's prefill
        slices FIFO on the prefill overlays (earliest-free timeline at
        the request's arrival, all slices contiguous — a dedicated
        prefill overlay has no decode to interleave with) and closes
        each with the MWU KV-ship; phase 2 runs the decode engines'
        continuous batching over the ready queue.  Phase 1 never depends
        on decode-side state, so placing it fully first is exact, not an
        approximation."""
        self.queue.finalize()
        plan = self.disagg_plan
        tr = self.tracer
        chunk_name = ("prefill_chunk" if self.prefill_chunk is not None
                      else "prefill")
        done: List[Request] = []
        while len(self.queue):
            req = self.queue.pop()
            done.append(req)
            tl = min(self.timelines[:self.prefill_overlays],
                     key=lambda l: (max(l.free, req.submit_cycle), l.idx))
            t = req.submit_cycle
            first = True
            spans = list(chunk_spans(len(req.prompt), self.prefill_chunk))
            for i, (base, rows) in enumerate(spans):
                prog = self._prefill_prog(rows, self.prefill_chunk)
                c = schedule_for(prog, self.cycle_model)["total_cycles"]
                s, t = tl.place(t, c)
                if first:
                    req.admit_cycle = s
                    first = False
                    self.stats.metrics.observe(
                        "queue_wait_cycles", s - req.submit_cycle)
                    if tr.enabled:
                        tr.request_admitted(req, tl.idx)
                self.stats.metrics.inc("charge_cycles", t - s,
                                       label="prefill")
                self.stats.metrics.observe("prefill_cycles", t - s)
                if tr.enabled:
                    tr.stream(tl.idx, "prefill", prog, s, t,
                              self.cycle_model)
                    tr.req_span(req.rid, chunk_name, s, t, tl.idx,
                                index=i, base=base, rows=rows,
                                of=len(spans))
            send = plan.send_prog(len(req.prompt))
            xfer = transfer_cycles(send)          # 1 row/cycle MWU ship
            s, t = tl.place(t, xfer, xfer)
            self.stats.metrics.inc("prefills")
            self.stats.metrics.inc("charge_cycles", t - s, label="kv_ship")
            if tr.enabled:
                tr.stream(tl.idx, "kv_ship", send, s, t, self.cycle_model)
                tr.req_span(req.rid, "kv_ship", s, t, tl.idx,
                            rows=len(req.prompt))
            tok = synthetic_token(req)            # cost-only first token
            req.generated.append(tok)
            req.first_token_cycle = t
            req.token_cycles.append(t)
            if tr.enabled:
                tr.instant(req.rid, "first_token", t)
            if req.wants_more():
                self._ready.push(t, req)
            else:
                req.finish_cycle = t
                if tr.enabled:
                    tr.instant(req.rid, "evict", t)
        self._ready.finalize()
        self._event_loop(self._ready)
        self.stats.requests = sorted(done, key=lambda r: r.rid)
        self.stats.tokens = sum(len(r.generated) for r in done)
        self.stats.makespan_cycles = max(
            [tl.free for tl in self.timelines]
            + [e.clock.cycles for e in self.engines] + [0])
        self.stats.busy_cycles = [tl.busy for tl in self.timelines]
        self.stats.transfer_cycles = sum(tl.xfer for tl in self.timelines)
        self._collect_stream_stats()
        return self.stats

    def run(self) -> FleetStats:
        """Serve every submitted request to completion; returns the
        fleet-level cycle-derived stats."""
        if self.shard == "expert":
            return self._run_expert()
        if self.shard == "prefill_decode":
            return self._run_prefill_decode()
        return self._run_engines()

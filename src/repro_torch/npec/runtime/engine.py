"""NPEEngine: a compiled-stream serving engine with batched decode.

A copy of `repro/npec/runtime/engine.py` in the port, which imports nothing
of the reference package.  The cost-only engine is the reference's line for
line.  The numeric route (`params` given) runs the port's executor on torch
tensors on one device, the card unless the caller passes device="cpu": NPE-8
projections through `quant_matmul`, the PWL softmax through `nvu_softmax`
with a key limit, and `nvu_layernorm` and `pwl_eval`.  Cycles, and the
milliseconds derived from them, are the FPGA overlay model's at its 200 MHz
clock, never time on the card.

The paper's deployment scenario is real-time conversational AI (§3.1,
10-15 ms/inference); the overlay executes it by loading compiled
instruction streams and re-running them (docs/isa.md).  This engine is
that serving loop in software, end-to-end on compiled programs:

  * **one batched decode stream** — compiled ONCE at `trace_decode(
    batch=B)`: B slots share the stream, weight projections run as B-row
    MMU tiles (occupancy ~B/128 instead of the ~0.78% a 1-row decode
    matmul sustains), each slot keeps its own cache bank and position;
    with `seq_buckets` the stream is compiled at several capacity
    buckets and every step clocks the smallest one covering the deepest
    live slot (bank rows migrate at crossings, 1 row/cycle); `window=W`
    compiles the ring variant whose banks never grow;
  * **a typed compiled-stream cache** — every decode bucket and prefill
    length goes through a `StreamCache` keyed by (family, kind, seq,
    batch, bits, nvu_source, cache_len, window)
    (repro_torch.npec.runtime.stream_cache), shareable across a fleet's
    engines without collision;
  * **compiled prefill per admitted request** — `compile_prefill` at the
    prompt's length (memoized per length): one causal pass seeds the
    slot's cache banks (`DecodeSession.load_slot`) and yields the first
    generated token, instead of S skinny decode steps;
  * **continuous batching** — FIFO queue + B-slot pool: admit into free
    slots, decode all occupied slots one token per step, evict on EOS or
    token budget (repro_torch.npec.runtime.batch);
  * **a cycle clock** — every step charges the scheduled cycles of the
    *actual* compiled stream under the engine's `cycle_model`:
    `"streaming"` (default, `stream_schedule` — tile-granular
    producer-consumer overlap, the paper's own latency model) or `"dag"`
    (`greedy_schedule`, the whole-op ablation).  Both step costs are
    recorded (`decode_step_cycles_dag` / `decode_step_cycles_streaming`)
    so serving tables can show the dag -> streaming latency delta;
    p50/p99 latency and tokens/sec come from that counter at the
    overlay's frequency, never from host wall-clock
    (repro_torch.npec.runtime.clock), so runs are bit-reproducible.  Matmul
    instructions charge padded tile cycles (ragged-tile charging,
    repro_torch.npec.lower), so the clocked stream IS what the 128-PE-row
    geometry sustains.

`params=None` runs the engine *cost-only*: the admission/eviction and
cycle accounting are identical but no numerics execute — generated
tokens come from a deterministic per-(request, step) synthetic stream
over a small alphabet, so EOS-aware workloads still exercise ragged
eviction, bit-reproducibly.  This is what
`benchmarks/paper_tables.py::npec_serve` records, keeping
results/npec_serve_cycles.json free of platform-BLAS noise.  With
`params`, every step runs the functional executor, so the served tokens
are the compiled streams' actual outputs (validated against per-sequence
`DecodeSession` rollouts in tests/test_torch_npec_runtime.py).

Families without decode streams (moe: per-token capacity-1 dispatch is a
ROADMAP open item) raise `CompileError` at construction — before any
scheduling, so the failure names the gap instead of crashing mid-run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.overlay import NPEHardware
from repro_torch.npec import (CompiledProgram, DecodeSession, compile_decode,
                              compile_prefill, execute, greedy_schedule,
                              schedule_for, stream_schedule, transfer_cycles)
from repro_torch.npec.exec import resolve_device
from repro_torch.npec.obs.metrics import MetricsRegistry
from repro_torch.npec.obs.tracer import NULL_TRACER
from repro_torch.npec.runtime.batch import Request, RequestQueue, SlotPool
from repro_torch.npec.runtime.clock import CycleClock, LatencyTracker
from repro_torch.npec.runtime.stream_cache import (StreamCache, StreamKey,
                                             bucket_for, decode_buckets)

# Cost-only runs have no logits to argmax, but EOS-aware workloads still
# need *some* deterministic token stream to evict against — draw from a
# small alphabet (multiplicative-hash PRN per request and step) so sampled
# EOS ids actually fire and completions go ragged, bit-reproducibly
# (results/npec_serve_cycles.json is guarded).  Module-level so the fleet's
# disaggregated prefill phase (repro_torch.npec.fleet.sim) emits the SAME first
# token a replicate engine would — token streams depend only on
# (rid, len(generated)), which is what makes disagg-vs-replicate token
# identity a testable invariant.
SYNTH_ALPHABET = 32


def synthetic_token(req: Request) -> int:
    h = (req.rid * 2654435761 + len(req.generated) * 40503) & 0xffffffff
    return int((h >> 16) % SYNTH_ALPHABET)


def chunk_spans(seq: int, chunk: Optional[int]) -> List[tuple]:
    """(base, rows) slices of a `seq`-token prompt at `chunk` granularity
    (chunk=None: one whole-prompt span)."""
    if chunk is None:
        return [(0, seq)]
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
    return [(b, min(chunk, seq - b)) for b in range(0, seq, chunk)]


@dataclass
class _PrefillState:
    """An admitted request mid-chunked-prefill: which slice runs next and
    the cache banks carried between slices (numeric mode: f32 tensors on
    the engine's device)."""
    req: Request
    spans: List[tuple]                       # (base, rows) per slice
    next_i: int = 0
    caches: Optional[Dict[str, torch.Tensor]] = None
    logits_tail: Optional[torch.Tensor] = None


@dataclass
class EngineStats:
    """Cycle-derived serving summary (all latencies at the overlay's
    clock).  Both cycle models' step costs are recorded —
    `decode_step_cycles` is the one the clock charged (`cycle_model`),
    with the dag/streaming pair alongside so the tile-streaming latency
    delta is auditable in every serving record.

    The serving counters (decode_steps, prefills, bucket migrations, the
    per-bucket step family) live in a `MetricsRegistry`
    (repro_torch.npec.obs.metrics) — one deterministic snapshot covering
    counters, labeled families, and exact cycle histograms — and are
    exposed here as read-only compatibility properties; `report()` is
    assembled from the same registry, so registry and report can never
    disagree."""
    requests: List[Request] = field(default_factory=list)
    total_cycles: int = 0
    cycle_model: str = "streaming"
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    decode_step_cycles: int = 0
    decode_step_cycles_dag: int = 0
    decode_step_cycles_streaming: int = 0
    mmu_row_occupancy: float = 0.0
    clock_hz: float = 200e6
    # length-bucketed decode (docs/serving.md): which compiled capacity
    # bucket each decode step ran at, plus the bank-migration traffic
    # (1 row/cycle MRU) paid at bucket crossings.  `decode_step_cycles`
    # above stays the LARGEST bucket's step cost — the fixed-capacity
    # engine's number — so bucketed records remain comparable.
    seq_buckets: tuple = ()
    window: Optional[int] = None
    stream_cache: Optional[StreamCache] = None
    latency: Optional[LatencyTracker] = None
    first_token: Optional[LatencyTracker] = None
    # end-to-end latency split at the admission boundary: queue-wait
    # (submit -> slot granted) vs service (slot granted -> finish) — the
    # split that makes fleet p99 under load attributable (docs/fleet.md)
    queue_wait: Optional[LatencyTracker] = None
    service: Optional[LatencyTracker] = None

    # registry-backed counter views (read-only; mutate via self.metrics)
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
        """The full observability snapshot: the report dict plus the
        registry's counters/families/histograms (serve.py --json)."""
        return {"report": self.report(), "metrics": self.metrics.snapshot()}

    def report(self) -> Dict[str, float]:
        gen = sum(len(r.generated) for r in self.requests)
        out = {"requests": len(self.requests), "generated_tokens": gen}
        out.update(self.latency.percentiles() if self.latency else {})
        if self.first_token:
            ft = self.first_token.percentiles(ps=(50,))
            out["first_token_p50_ms"] = ft["p50_ms"]
        if self.queue_wait:
            qw = self.queue_wait.percentiles()
            out["queue_wait_p50_ms"] = qw["p50_ms"]
            out["queue_wait_p99_ms"] = qw["p99_ms"]
        if self.service:
            sv = self.service.percentiles()
            out["service_p50_ms"] = sv["p50_ms"]
            out["service_p99_ms"] = sv["p99_ms"]
        # full precision here — consumers round at the presentation layer
        # (serve.py prints 1/4 decimals, paper_tables rounds its rows), so
        # downstream math never inherits print-precision loss
        out["tokens_per_sec"] = (
            gen * self.clock_hz / self.total_cycles
            if self.total_cycles else 0.0)
        out["cycle_model"] = self.cycle_model
        out["decode_step_cycles"] = self.decode_step_cycles
        out["decode_step_cycles_dag"] = self.decode_step_cycles_dag
        out["decode_step_cycles_streaming"] = \
            self.decode_step_cycles_streaming
        out["mmu_row_occupancy"] = self.mmu_row_occupancy
        out["total_cycles"] = self.total_cycles
        out["decode_steps"] = self.decode_steps
        out["prefills"] = self.prefills
        out["seq_buckets"] = list(self.seq_buckets)
        if self.window is not None:
            out["window"] = self.window
        out["decode_steps_by_bucket"] = {
            str(b): n
            for b, n in sorted(self.decode_steps_by_bucket.items())}
        out["bucket_migrations"] = self.bucket_migrations
        out["migration_cycles"] = self.migration_cycles
        if self.stream_cache is not None:
            out.update(self.stream_cache.report())
        return out


class NPEEngine:
    """Continuous-batching serving engine over compiled overlay streams."""

    def __init__(self, cfg: ModelConfig, hw: Optional[NPEHardware] = None,
                 *, slots: int = 4, capacity: int = 64,
                 max_new_tokens: int = 16, bits: int = 16,
                 npe: bool = False, params: Any = None,
                 nvu_source: str = "paper", eos_id: Optional[int] = None,
                 cycle_model: str = "streaming",
                 stream_cache: Optional[StreamCache] = None,
                 seq_buckets=None, window: Optional[int] = None,
                 charge_hook=None, queue=None, engine_id: int = 0,
                 prefill_chunk: Optional[int] = None, kv_recv=None,
                 tracer=None, device="cuda"):
        """Fleet extension points (repro_torch.npec.fleet) — all default to the
        lone-engine behavior, which stays byte-identical:

          * `stream_cache`: a shared `StreamCache` — a fleet hands the
            SAME cache to every engine so compiled streams (and their
            memoized schedules) are compiled once per `StreamKey` instead
            of once per overlay.  Keys carry (family, kind, seq, batch,
            bits, nvu_source, cache_len, window), so heterogeneous fleets
            can never collide streams that merely share a length;
          * `charge_hook(engine, kind, prog, cycles)`: replaces
            `clock.advance` for every stream charge (`kind` is "prefill",
            "decode", "kv_recv" or "migrate") — the fleet uses it to
            place the charge on shared overlay timelines and advance this
            engine's clock to the placed completion cycle;
          * `queue`: an external admission queue (anything with
            `__bool__` and `pop()`) — the fleet's shared queue gates
            `__bool__` on this engine's clock vs request arrival cycles.
            Requests admitted from an external queue are appended to
            `stats.requests` at admission (they were never `submit`ted
            here);
          * `engine_id`: this engine's overlay index (deterministic fleet
            tie-breaking);
          * `tracer`: a `repro_torch.npec.obs.Tracer` — strictly opt-in; the
            default NULL_TRACER has enabled=False and every emission site
            is gated on it, so the untraced path does no extra work and
            reports stay byte-identical.  `trace_overlay` is the overlay
            index trace events carry (fleets override it where an
            engine's timeline is not overlay `engine_id`, e.g. the
            disaggregated decode overlays); `trace_streams=False`
            suppresses the engine's own overlay-track emission when the
            fleet places stage costs itself (pipeline sharding).

        Serving-shape extension points:

          * `prefill_chunk=C`: chunked prefill — an admit binds its slot
            immediately but streams the prompt as ceil(S/C) causal cache
            slices (`compile_prefill(cache_len=capacity)`), at most ONE
            slice interleaved per engine step, so a decode step is never
            stalled by more than one slice's scheduled cycles (the p99
            cliff an unchunked admit causes);
          * `kv_recv(seq) -> CompiledProgram`: disaggregated *decode*
            overlay — admission charges the returned MRU recv stream (the
            KV rows shipped from a prefill overlay) instead of running a
            prefill; requests arrive with their first token already
            generated.  Cost-only (`params` must be None) and mutually
            exclusive with `prefill_chunk`.

        Cache-shape extension points (docs/serving.md):

          * `seq_buckets`: length-bucketed decode — compile the decode
            stream at several capacity buckets (`"auto"`: 64, 128, ...
            doubling up to `capacity`; or an explicit ascending list) and
            clock every step at the SMALLEST bucket covering the deepest
            live slot, migrating cache banks (1 row/cycle MRU traffic,
            kind="migrate") at crossings.  Tokens are bit-identical to
            the fixed-capacity engine: rows past a slot's position are
            zeros in both banks and inert under the pos-masked softmax;
          * `window=W`: ring (sliding-window) decode — ONE bucket that
            never grows: appends wrap at W, positions grow unbounded.
            Prompts must fit W (a causal S <= W prefill is exactly the
            sliding model's own computation).  Mutually exclusive with
            `seq_buckets` and `prefill_chunk`.

        Numeric route (the port's): `params` is the executor's parameter
        tree or a `ParamTree`, resolved once onto `device` (default the
        card; raises without one unless device="cpu"); the decode session
        and every prefill reuse it.  A cost-only engine (params=None)
        allocates no tensor and ignores `device`."""
        if cycle_model not in ("dag", "streaming"):
            raise ValueError(f"unknown cycle model {cycle_model!r}")
        if window is not None:
            if seq_buckets is not None:
                raise ValueError(
                    "window and seq_buckets are mutually exclusive: a "
                    "ring cache is the one bucket that never grows")
            if prefill_chunk is not None:
                raise ValueError(
                    "windowed engines prefill whole prompts (the prompt "
                    "fits the window); prefill_chunk is unsupported with "
                    "window=")
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if kv_recv is not None:
            if params is not None:
                raise ValueError(
                    "kv_recv engines are cost-only: the KV rows arrive by "
                    "transfer, not by executing a prefill (params=None)")
            if prefill_chunk is not None:
                raise ValueError(
                    "kv_recv decode overlays never prefill; prefill_chunk "
                    "belongs on the prefill side")
        self.cfg = cfg
        self.hw = hw if hw is not None else NPEHardware()
        self.slots = slots
        self.capacity = capacity
        self.max_new_tokens = max_new_tokens
        self.bits = bits
        self.eos_id = eos_id
        self.nvu_source = nvu_source
        self.cycle_model = cycle_model
        self.engine_id = engine_id
        self.charge_hook = charge_hook
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_overlay = engine_id
        self.trace_streams = True
        # critical-path inter-overlay transfer cycles inside the LAST
        # charge, written back by a fleet's charge hook (tensor sharding):
        # request spans split the charged window into compute + an
        # `allreduce` tail so profile.py can attribute communication vs
        # compute per request.  Always 0 on the lone-engine path.
        self._xfer_attr = 0
        self.stream_cache = (stream_cache if stream_cache is not None
                             else StreamCache())
        self.window = int(window) if window is not None else None
        self.windowed = self.window is not None
        self.buckets = ((self.window,) if self.windowed
                        else decode_buckets(capacity, seq_buckets))
        # compile the batched decode stream(s) FIRST: unsupported families
        # (moe decode) raise CompileError here, before any scheduling.
        # All buckets go through the stream cache, so a fleet sharing one
        # cache compiles each (family, bucket, batch, bits, ...) once.
        self._decode_progs: Dict[int, CompiledProgram] = {}
        for bkt in self.buckets:
            key = StreamKey(cfg.name, "decode", bkt, slots, bits,
                            nvu_source, window=self.windowed)
            self._decode_progs[bkt] = self.stream_cache.get(
                key, lambda b=bkt: compile_decode(
                    cfg, b, self.hw, bits=bits, nvu_source=nvu_source,
                    batch=slots, window=self.windowed))
        self.decode_prog = self._decode_progs[self.buckets[-1]]
        tiling = self.decode_prog.mmu_tiling_summary()
        self.step_cycles_dag = int(
            greedy_schedule(self.decode_prog)["total_cycles"])
        self.step_cycles_streaming = int(
            stream_schedule(self.decode_prog)["total_cycles"])
        self.step_cycles = int(self._schedule_cycles(self.decode_prog))
        self._bucket_step_cycles = {
            b: int(self._schedule_cycles(p))
            for b, p in self._decode_progs.items()}
        self.mmu_row_occupancy = tiling["efficiency"]
        # every slot's cache banks are per-slot in a batch=B stream, so
        # migration traffic is banks_per_slot rows per live position
        self._banks_per_slot = max(
            1, len(self.decode_prog.graph.caches) // slots)
        self._bucket = self.buckets[0]
        self._slot_pos = np.zeros(slots, np.int64)

        self.numeric = params is not None
        self._npe_cfg = (cfg.with_npe(quant_bits=bits) if npe else None)
        self.device = resolve_device(device) if self.numeric else None
        self.session = (DecodeSession(self._decode_progs[self._bucket],
                                      params, cfg=self._npe_cfg,
                                      device=self.device)
                        if self.numeric else None)
        # every prefill reuses the session's resolved parameter slices
        self.params = self.session.params if self.numeric else None

        self.clock = CycleClock(self.hw.clock_hz)
        self._external_queue = queue is not None
        self.queue = queue if queue is not None else RequestQueue()
        self.pool = SlotPool(slots)
        self._next_tok = np.zeros(slots, np.int32)
        self.prefill_chunk = prefill_chunk
        self.kv_recv = kv_recv
        # slot -> _PrefillState, insertion-ordered: chunked admits stream
        # their slices FIFO, one slice per engine step
        self._prefilling: Dict[int, _PrefillState] = {}
        self.stats = EngineStats(
            cycle_model=cycle_model,
            decode_step_cycles=self.step_cycles,
            decode_step_cycles_dag=self.step_cycles_dag,
            decode_step_cycles_streaming=self.step_cycles_streaming,
            mmu_row_occupancy=self.mmu_row_occupancy,
            clock_hz=self.hw.clock_hz,
            seq_buckets=self.buckets,
            window=self.window,
            stream_cache=self.stream_cache)
        self.stats.latency = LatencyTracker(self.clock)
        self.stats.first_token = LatencyTracker(self.clock)
        self.stats.queue_wait = LatencyTracker(self.clock)
        self.stats.service = LatencyTracker(self.clock)

    # --- request intake ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None) -> Request:
        """Queue a prompt; its cache slot must fit prompt + generation.
        `eos_id` overrides the engine-wide EOS token for this request
        (EOS-aware workloads sample one per request), so eviction can be
        ragged instead of budget-only."""
        prompt = np.asarray(prompt, np.int32)
        new = max_new_tokens if max_new_tokens is not None \
            else self.max_new_tokens
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {new} (prefill always "
                "emits the first generated token)")
        # the prefill itself emits the first generated token, so a request
        # occupies prompt + new - 1 cache rows: the last decode append
        # (token new-1 of new) lands on row prompt + new - 2, and
        # prompt + new == capacity exactly fills the bank
        if prompt.size + new - 1 > self.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({new}) needs "
                f"{prompt.size + new - 1} cache rows and exceeds "
                f"the compiled cache capacity {self.capacity}")
        if self.windowed and prompt.size > self.window:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds the ring window "
                f"{self.window}: windowed prefill is exact only for "
                f"prompts that fit the window")
        req = self.queue.submit(prompt, max_new_tokens=new,
                                eos_id=(eos_id if eos_id is not None
                                        else self.eos_id),
                                submit_cycle=self.clock.cycles)
        self.stats.requests.append(req)
        return req

    # --- serving loop -----------------------------------------------------

    def _prefill_program(self, seq: int) -> CompiledProgram:
        """The compiled prefill stream for `seq` rows — the whole prompt
        (kind "prefill") or one cache-bank slice (chunked engines, kind
        "prefill_chunk" with the bank capacity in the key), memoized in
        the stream cache.  The typed key — not a bare (seq, chunk) tuple
        — is what makes cross-engine collisions in a shared fleet cache
        structurally impossible: two engines only ever share a stream
        when family, kind, rows, bits, nvu_source, cache_len and window
        ALL agree."""
        chunked = self.prefill_chunk is not None
        cache_len = self.capacity if chunked else None
        key = StreamKey(self.cfg.name,
                        "prefill_chunk" if chunked else "prefill",
                        seq, 1, self.bits, self.nvu_source,
                        cache_len=cache_len, window=self.windowed)
        return self.stream_cache.get(key, lambda: compile_prefill(
            self.cfg, seq, self.hw, bits=self.bits,
            nvu_source=self.nvu_source, cache_len=cache_len,
            window=self.windowed))

    def _schedule_cycles(self, prog: CompiledProgram) -> float:
        return schedule_for(prog, self.cycle_model)["total_cycles"]

    def _charge(self, kind: str, prog: CompiledProgram,
                cycles: float) -> tuple:
        """Charge a compiled stream to the clock — or hand the charge to
        the fleet's hook, which places it on shared overlay timelines and
        advances this engine's clock to the placed completion cycle.
        Returns the integer engine-clock window ``(t0, t1)`` the charge
        occupied, which is what the tracer's spans and the per-request
        attributions are stamped with."""
        t0 = self.clock.cycles
        self._xfer_attr = 0              # hooks set it per charge
        if self.charge_hook is not None:
            self.charge_hook(self, kind, prog, cycles)
        else:
            self.clock.advance(cycles)
        t1 = self.clock.cycles
        self.stats.metrics.inc("charge_cycles", t1 - t0, label=kind)
        tr = self.tracer
        if tr.enabled and self.trace_streams:
            tr.stream(self.trace_overlay, kind, prog, t0, t1,
                      self.cycle_model)
        return t0, t1

    # --- length-bucketed decode -------------------------------------------

    def _ensure_bucket(self, need: int) -> None:
        """Move the engine onto the SMALLEST compiled bucket covering
        `need` cache rows, migrating live cache banks on a crossing.

        Exactness: rows past a slot's position are zeros in the old bank
        and inert under the pos-masked softmax in the new one, so copying
        the leading `pos` live rows per bank reproduces the fixed-capacity
        engine's state bit-for-bit (the einsum over extra zero key columns
        adds exact zeros).  The traffic is charged at the MRU/MWU transfer
        rate, 1 row/cycle (kind="migrate"), on both the numeric and the
        cost-only path — `DecodeSession.migrate` returns the rows it
        actually moved, which must equal the analytic charge."""
        if self.windowed:
            return                       # the ring never grows
        # never shrink below the deepest live slot: its next append lands
        # at row `pos`, so every bank must keep pos + 1 rows addressable
        deepest = int(self._slot_pos.max()) if self.slots else 0
        target = bucket_for(self.buckets, max(int(need), deepest + 1, 1))
        if target == self._bucket:
            return
        rows = int(self._banks_per_slot * self._slot_pos.sum())
        prog = self._decode_progs[target]
        if self.numeric:
            moved = self.session.migrate(prog)
            assert moved == rows, (
                f"bucket migration moved {moved} rows but the cost model "
                f"charged {rows}")
        self._bucket = target
        self.stats.metrics.inc("bucket_migrations")
        self.stats.metrics.inc("migration_cycles", rows)
        if rows:
            t0, t1 = self._charge("migrate", prog, float(rows))
            if self.tracer.enabled:
                # attribute the moved rows to the slots that own them
                live = [r.rid for s, r in self.pool.active()
                        if self._slot_pos[s] > 0]
                if live:
                    self.tracer.req_split(live, "migrate", t0, t1,
                                          self.trace_overlay,
                                          bucket=target)

    SYNTH_ALPHABET = SYNTH_ALPHABET      # see module-level synthetic_token

    def _synthetic_token(self, req: Request) -> int:
        return synthetic_token(req)

    def _admit(self, slot: int, req: Request) -> None:
        """Admit one request into a free slot.  Default: one whole-prompt
        compiled prefill (charge the stream, seed the banks, emit the
        first token).  Chunked engines only bind and enqueue the slices;
        disaggregated decode overlays charge the KV recv transfer."""
        if self.kv_recv is not None:
            self._admit_kv(slot, req)
            return
        if self.prefill_chunk is not None:
            self._admit_chunked(slot, req)
            return
        prog = self._prefill_program(len(req.prompt))
        if self._external_queue:
            self.stats.requests.append(req)
        req.admit_cycle = self.clock.cycles
        self.stats.queue_wait.record(req.submit_cycle, req.admit_cycle)
        self.stats.metrics.observe("queue_wait_cycles",
                                   req.admit_cycle - req.submit_cycle)
        tr = self.tracer
        if tr.enabled:
            tr.request_admitted(req, self.trace_overlay)
        t0, t1 = self._charge("prefill", prog, self._schedule_cycles(prog))
        self.stats.metrics.inc("prefills")
        self.stats.metrics.observe("prefill_cycles", t1 - t0)
        if tr.enabled:
            # a tensor fleet's hook reports the critical-path all-reduce
            # share of the charge; split it off the compute span so the
            # request track attributes communication separately
            tm = t1 - self._xfer_attr
            tr.req_span(req.rid, "prefill", t0, tm, self.trace_overlay,
                        rows=len(req.prompt))
            if tm < t1:
                tr.req_span(req.rid, "allreduce", tm, t1,
                            self.trace_overlay, rows=len(req.prompt))
        self._ensure_bucket(len(req.prompt))   # load needs S rows per bank
        if self.numeric:
            res = execute(prog, self.params, {"tokens": req.prompt},
                          cfg=self._npe_cfg, device=self.device)
            self.session.load_slot(slot, res.kv_exports, len(req.prompt))
            tok = self._first_token(res[0][..., -1, :])
        else:
            tok = self._synthetic_token(req)
        self.pool.bind(slot, req)
        self._slot_pos[slot] = len(req.prompt)
        req.generated.append(tok)
        req.first_token_cycle = self.clock.cycles
        req.token_cycles.append(self.clock.cycles)
        self.stats.first_token.record(req.submit_cycle, self.clock.cycles)
        if tr.enabled:
            tr.instant(req.rid, "first_token", req.first_token_cycle)
        self._next_tok[slot] = tok
        if not req.wants_more():
            self._finish(slot)

    def _admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked admission: the slot is granted now, but the prompt
        streams as causal cache slices — one per engine step
        (_prefill_step) — so decoding slots stall by at most one slice."""
        if self._external_queue:
            self.stats.requests.append(req)
        req.admit_cycle = self.clock.cycles
        self.stats.queue_wait.record(req.submit_cycle, req.admit_cycle)
        self.stats.metrics.observe("queue_wait_cycles",
                                   req.admit_cycle - req.submit_cycle)
        if self.tracer.enabled:
            self.tracer.request_admitted(req, self.trace_overlay)
        self.pool.bind(slot, req)
        self._prefilling[slot] = _PrefillState(
            req, chunk_spans(len(req.prompt), self.prefill_chunk))

    def _admit_kv(self, slot: int, req: Request) -> None:
        """Disaggregated decode-overlay admission: the request's KV cache
        was built by a prefill overlay and ships in as MRU recv rows —
        charge that transfer stream, then decode from its last token."""
        prog = self.kv_recv(len(req.prompt))
        if self._external_queue:
            self.stats.requests.append(req)
        if req.admit_cycle < 0:
            req.admit_cycle = self.clock.cycles
            self.stats.queue_wait.record(req.submit_cycle, req.admit_cycle)
            self.stats.metrics.observe("queue_wait_cycles",
                                       req.admit_cycle - req.submit_cycle)
            if self.tracer.enabled:
                self.tracer.request_admitted(req, self.trace_overlay)
        t0, t1 = self._charge("kv_recv", prog, transfer_cycles(prog))
        if self.tracer.enabled:
            self.tracer.req_span(req.rid, "kv_recv", t0, t1,
                                 self.trace_overlay, rows=len(req.prompt))
        self._ensure_bucket(len(req.prompt))   # recv fills S rows per bank
        self.pool.bind(slot, req)
        self._slot_pos[slot] = len(req.prompt)
        assert req.generated, (
            "kv_recv admission expects the prefill overlay's first token")
        self._next_tok[slot] = req.generated[-1]
        if not req.wants_more():
            self._finish(slot)

    def _prefill_step(self) -> bool:
        """Run at most ONE prefill slice — the oldest admitted prefilling
        slot's next chunk.  Numeric mode carries the cache banks between
        slices (cache_updates) and keeps the slice logits for the first
        token; the final slice seeds the decode slot (load_slot)."""
        slot = next(iter(self._prefilling))
        st = self._prefilling[slot]
        base, rows = st.spans[st.next_i]
        prog = self._prefill_program(rows)
        t0, t1 = self._charge("prefill", prog, self._schedule_cycles(prog))
        self.stats.metrics.observe("prefill_cycles", t1 - t0)
        if self.tracer.enabled:
            tm = t1 - self._xfer_attr
            self.tracer.req_span(st.req.rid, "prefill_chunk", t0, tm,
                                 self.trace_overlay, index=st.next_i,
                                 base=base, rows=rows,
                                 of=len(st.spans))
            if tm < t1:
                self.tracer.req_span(st.req.rid, "allreduce", tm, t1,
                                     self.trace_overlay, rows=rows)
        if self.numeric:
            if st.caches is None:
                g = prog.graph
                st.caches = {name: torch.zeros(g.node(nid).shape,
                                               dtype=torch.float32,
                                               device=self.device)
                             for name, nid in g.caches.items()}
            feeds: Dict[str, Any] = dict(st.caches)
            feeds["pos_ids"] = np.arange(base, base + rows, dtype=np.int32)
            feeds["tokens"] = st.req.prompt[base:base + rows]
            res = execute(prog, self.params, feeds, cfg=self._npe_cfg,
                          device=self.device)
            st.caches.update(res.cache_updates)
            st.logits_tail = res[0]
        st.next_i += 1
        if st.next_i == len(st.spans):
            self._finish_prefill(slot)
        return True

    def _finish_prefill(self, slot: int) -> None:
        """Last slice done: seed the decode slot from the carried banks
        and emit the first generated token (same semantics as the
        whole-prompt admit's tail)."""
        st = self._prefilling.pop(slot)
        req = st.req
        self.stats.metrics.inc("prefills")
        self._ensure_bucket(len(req.prompt))   # load needs S rows per bank
        if self.numeric:
            S = len(req.prompt)
            self.session.load_slot(
                slot, {name: arr[:S] for name, arr in st.caches.items()}, S)
            tok = self._first_token(st.logits_tail[..., -1, :])
        else:
            tok = self._synthetic_token(req)
        self._slot_pos[slot] = len(req.prompt)
        req.generated.append(tok)
        req.first_token_cycle = self.clock.cycles
        req.token_cycles.append(self.clock.cycles)
        self.stats.first_token.record(req.submit_cycle, self.clock.cycles)
        if self.tracer.enabled:
            self.tracer.instant(req.rid, "first_token",
                                req.first_token_cycle)
        self._next_tok[slot] = tok
        if not req.wants_more():
            self._finish(slot)

    @staticmethod
    def _first_token(logits: torch.Tensor) -> int:
        """The greedy token of a prefill's last row: the prefill's one host
        sync (torch.argmax takes the first index on ties, as np.argmax)."""
        return int(torch.argmax(logits))

    def _finish(self, slot: int) -> None:
        req = self.pool.release(slot)
        req.finish_cycle = self.clock.cycles
        self.stats.latency.record(req.submit_cycle, req.finish_cycle)
        self.stats.service.record(req.admit_cycle, req.finish_cycle)
        self.stats.metrics.observe("service_cycles",
                                   req.finish_cycle - req.admit_cycle)
        self.stats.metrics.observe("e2e_cycles",
                                   req.finish_cycle - req.submit_cycle)
        if self.tracer.enabled:
            self.tracer.instant(req.rid, "evict", req.finish_cycle)
        if self.numeric:
            self.session.reset_slot(slot)
        self._next_tok[slot] = 0
        self._slot_pos[slot] = 0

    def step(self) -> bool:
        """Admit into free slots, interleave at most one prefill slice
        (chunked engines), then decode every generating slot one token
        with the batched stream.  Returns False when idle (nothing
        admitted, prefilling, or decoding — admissions alone count as
        progress: a request can finish at its first token).

        A slot whose LAST slice ran this step decodes in this same step
        (first token at prefill completion, second from the decode pass)
        — exactly the whole-prompt admit's semantics, just with the
        stream sliced."""
        admitted = 0
        for slot in self.pool.free_ids():
            if not self.queue:
                break
            self._admit(slot, self.queue.pop())
            admitted += 1
        chunked = self._prefill_step() if self._prefilling else False
        active = self.pool.active_mask()
        for s in self._prefilling:          # bound but not yet generating
            active[s] = False
        if not active.any():
            return admitted > 0 or chunked
        # every decoding slot's next append lands at row pos, so the step
        # runs on the smallest bucket covering deepest-pos + 1 rows
        self._ensure_bucket(int(self._slot_pos[active].max()) + 1)
        t0, t1 = self._charge("decode", self._decode_progs[self._bucket],
                              self._bucket_step_cycles[self._bucket])
        self.stats.metrics.inc("decode_steps")
        self.stats.metrics.inc("decode_steps_by_bucket",
                               label=self._bucket)
        self.stats.metrics.observe("decode_step_cycles", t1 - t0)
        if self.tracer.enabled:
            rids = [r.rid for s, r in self.pool.active()
                    if s not in self._prefilling]
            tm = t1 - self._xfer_attr
            self.tracer.req_split(rids, "decode_step", t0, tm,
                                  self.trace_overlay, bucket=self._bucket)
            if tm < t1:
                self.tracer.req_split(rids, "allreduce", tm, t1,
                                      self.trace_overlay,
                                      bucket=self._bucket)
        if self.numeric:
            out = self.session.step(self._next_tok, active=active)
            # the step's one host sync: the (B,) greedy tokens come to the
            # host for the EOS check (torch.argmax takes the first index on
            # ties, as np.argmax does)
            next_tok = torch.argmax(out, dim=-1).to(torch.int32).cpu().numpy()
        else:
            next_tok = np.zeros(self.slots, np.int32)
            for slot, req in self.pool.active():
                if slot in self._prefilling:
                    continue
                next_tok[slot] = self._synthetic_token(req)
        self._slot_pos[active] += 1            # this step's cache appends
        for slot, req in self.pool.active():
            if slot in self._prefilling:
                continue
            tok = int(next_tok[slot])
            req.generated.append(tok)
            req.token_cycles.append(self.clock.cycles)
            self._next_tok[slot] = tok
            if not req.wants_more():
                self._finish(slot)
        return True

    def run(self) -> EngineStats:
        """Drain the queue; returns the cycle-derived stats."""
        while self.queue or len(self.pool):
            if not self.step():
                break
        self.stats.total_cycles = self.clock.cycles
        return self.stats

"""Event/metric name constants and the Perfetto trace schema checker.

A copy of `repro/npec/obs/schema.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

These constants are the single source of truth for every event and
metric name the observability layer emits — docs/observability.md lists
the same names, and scripts/ci.sh greps that doc against this module so
the two cannot drift.
"""

from __future__ import annotations

from typing import List

from repro_torch.npec.obs.tracer import UNITS  # noqa: F401  (re-exported)

# --- request-track event names (lifecycle spans + instants) --------------
SPAN_QUEUE = "queue"
SPAN_PREFILL = "prefill"
SPAN_PREFILL_CHUNK = "prefill_chunk"
SPAN_DECODE = "decode_step"
SPAN_MIGRATE = "migrate"
SPAN_KV_RECV = "kv_recv"
SPAN_KV_SHIP = "kv_ship"
SPAN_EXPERT = "expert_phase"
#: Tensor-sharded fleets split each charged window into compute + the
#: critical-path all-reduce tail (repro_torch.npec.fleet `_tensor_hook` ->
#: `NPEEngine._xfer_attr`), so communication is attributable per request.
SPAN_ALLREDUCE = "allreduce"

REQUEST_SPANS = (SPAN_QUEUE, SPAN_PREFILL, SPAN_PREFILL_CHUNK, SPAN_DECODE,
                 SPAN_MIGRATE, SPAN_KV_RECV, SPAN_KV_SHIP, SPAN_EXPERT,
                 SPAN_ALLREDUCE)

INSTANT_SUBMIT = "submit"
INSTANT_FIRST_TOKEN = "first_token"
INSTANT_EVICT = "evict"

REQUEST_INSTANTS = (INSTANT_SUBMIT, INSTANT_FIRST_TOKEN, INSTANT_EVICT)

#: Profiler attribution category per charged request span: where a
#: request's cycles went, queue-wait aside (the queue span is wait, not
#: charged work).
ATTR_CATEGORY = {
    SPAN_PREFILL: "prefill",
    SPAN_PREFILL_CHUNK: "prefill",
    SPAN_DECODE: "decode",
    SPAN_KV_RECV: "transfer",
    SPAN_KV_SHIP: "transfer",
    SPAN_MIGRATE: "migrate",
    SPAN_EXPERT: "expert",
    SPAN_ALLREDUCE: "transfer",
}

# --- overlay-track stream kinds ------------------------------------------
STREAM_KINDS = ("prefill", "decode", "kv_recv", "kv_ship", "migrate",
                "expert")

# --- metric names (MetricsRegistry) --------------------------------------
METRIC_COUNTERS = ("decode_steps", "prefills", "bucket_migrations",
                   "migration_cycles", "stream_cache_hits",
                   "stream_cache_misses")
METRIC_FAMILIES = ("decode_steps_by_bucket", "charge_cycles")
METRIC_HISTOGRAMS = ("decode_step_cycles", "prefill_cycles",
                     "queue_wait_cycles", "service_cycles", "e2e_cycles")

_EPS = 1e-6


def validate_trace(trace: dict) -> List[str]:
    """Schema-check an exported Chrome/Perfetto trace dict.

    Returns a list of violations (empty == valid): required top-level and
    per-event keys, known phases, named pid/tid tracks (every track with
    events must carry ``process_name``/``thread_name`` metadata), known
    request-track event names, and — the structural invariant the
    timeline views rely on — per-track ``X`` spans sorted by start and
    non-overlapping (touching allowed)."""
    errs: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    other = trace.get("otherData", {})
    if not isinstance(other.get("clock_hz"), (int, float)):
        errs.append("otherData.clock_hz missing")
    named_pids, named_tids = set(), set()
    spans: dict = {}
    request_names = set(REQUEST_SPANS) | set(REQUEST_INSTANTS)
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                errs.append(f"event {i}: missing {key!r}")
        if not isinstance(ev.get("args"), dict):
            errs.append(f"event {i}: missing args object")
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            elif ev.get("name") == "thread_name":
                named_tids.add((ev.get("pid"), ev.get("tid")))
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i}: missing numeric ts")
            continue
        if ev.get("ts", 0) < 0:
            errs.append(f"event {i}: negative ts")
        if ev.get("cat") == "request" and ev.get("name") not in request_names:
            errs.append(
                f"event {i}: unknown request event {ev.get('name')!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event needs dur >= 0")
                continue
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], dur, ev.get("name")))
    for (pid, tid), lane in spans.items():
        if pid not in named_pids:
            errs.append(f"pid {pid}: no process_name metadata")
        if (pid, tid) not in named_tids:
            errs.append(f"track {pid}/{tid}: no thread_name metadata")
        prev_ts, prev_end, prev_name = None, None, None
        for ts, dur, name in lane:
            if prev_ts is not None and ts < prev_ts - _EPS:
                errs.append(
                    f"track {pid}/{tid}: spans out of order at "
                    f"{name!r} (ts {ts} after {prev_ts})")
            if prev_end is not None and ts < prev_end - _EPS:
                errs.append(
                    f"track {pid}/{tid}: {name!r} at {ts} overlaps "
                    f"{prev_name!r} ending {prev_end}")
            prev_ts, prev_end, prev_name = ts, max(ts + dur,
                                                   prev_end or 0), name
        # named-pid checks only need to fire once per lane
    return errs

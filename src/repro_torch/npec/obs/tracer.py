"""Cycle-domain tracer: span/instant events for requests and overlay units.

A copy of `repro/npec/obs/tracer.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

The tracer records two families of timelines, all timestamped in integer
engine-clock cycles (``CycleClock``) — never wall clock, so two identical
runs produce byte-identical traces:

* **request tracks** (one per request): the full lifecycle
  ``submit -> queue -> admit -> prefill_chunk[i] -> decode_step(bucket)
  -> migrate -> kv_ship -> evict``.  Every charged span carries an
  ``attributed`` integer cycle count: a charge shared by several requests
  (a batched decode step, a bank migration) is split exactly — floor
  share per request, remainder to the lowest rids — so the per-request
  attributions sum to the charged span length *exactly*, which is what
  the conservation gates in tests/test_npec_obs.py check.

* **overlay tracks** (one per overlay x unit, plus a ``stream`` track of
  charged compiled streams and a ``stalls`` track): per-unit busy
  windows come from the memoized compiled schedule
  (`schedule_for(prog, model)`), stall gaps re-emit
  `schedule.stream_schedule`'s attributed stall intervals
  (``stall_intervals``, same keys as its ``stalls`` budgets) offset to
  the engine clock.

Tracing is strictly opt-in: the engine and fleet default to
:data:`NULL_TRACER`, whose ``enabled`` flag is False and whose methods
are no-ops — every emission call site is gated on ``tracer.enabled``, so
the disabled path does no work and all existing reports stay
byte-identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.npec.schedule import schedule_for

#: Overlay execution units with dedicated trace tracks.
UNITS = ("MMU", "NVU", "MRU", "MWU")

#: Which units a pure-transfer charge occupies (1 row/cycle, docs/isa.md):
#: KV recv streams in over the read port, KV ship out over the write port,
#: a bank migration reads the old bank and writes the new one.
TRANSFER_UNITS = {
    "kv_recv": ("MRU",),
    "kv_ship": ("MWU",),
    "migrate": ("MRU", "MWU"),
}


class NullTracer:
    """Disabled tracer: ``enabled`` is False and every method no-ops.

    Call sites check ``tracer.enabled`` before building event payloads,
    so the disabled path costs one attribute read per charge."""

    enabled = False

    def stream(self, *a, **k):
        pass

    def request_admitted(self, *a, **k):
        pass

    def req_span(self, *a, **k):
        pass

    def req_split(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass


#: The shared no-op tracer every engine/fleet defaults to.
NULL_TRACER = NullTracer()


class Tracer:
    """Collects cycle-stamped events; export via repro_torch.npec.obs.export.

    Events are plain dicts ``{"ph", "name", "cat", "track", "ts",
    "dur", "args"}`` where ``track`` is ``("overlay", idx, lane)`` or
    ``("request", rid)`` — the exporter maps tracks onto Chrome
    trace-event pid/tid pairs.  Alongside the event list the tracer keeps
    exact aggregates (per-unit busy, per-key stalls, per-overlay charged
    cycles, per-request attributed cycles) that the conservation gates
    and the profiler reconcile against the run's cycle report."""

    enabled = True

    def __init__(self, clock_hz: float = 200e6):
        self.clock_hz = clock_hz
        self.events: List[dict] = []
        # exact aggregates (integers where the clock is integral)
        self.charged: Dict[int, int] = {}               # overlay -> cycles
        self.unit_busy: Dict[Tuple[int, str], float] = {}
        self.stalls: Dict[Tuple[int, str], float] = {}  # (overlay, key)
        self.attributed: Dict[int, int] = {}            # rid -> cycles
        self.attr_by_name: Dict[Tuple[int, str], int] = {}
        # strong refs keep id() keys stable for the per-program memo
        self._unit_memo: Dict[Tuple[int, str], tuple] = {}

    # --- overlay-side emission -------------------------------------------

    def _unit_windows(self, prog, model: str) -> tuple:
        """(windows, busy) for a compiled program under a cycle model:
        per-unit (first_start, last_end) in stream-local cycles from the
        memoized schedule, plus the exact integer busy sums."""
        key = (id(prog), model)
        hit = self._unit_memo.get(key)
        if hit is not None:
            return hit[1], hit[2]
        sched = schedule_for(prog, model)
        start, end = sched["start"], sched["end"]
        windows: Dict[str, Tuple[float, float]] = {}
        for i, ins in enumerate(prog.instrs):
            u = ins.unit
            if u in windows:
                lo, hi = windows[u]
                windows[u] = (min(lo, start[i]), max(hi, end[i]))
            else:
                windows[u] = (start[i], end[i])
        busy = prog.busy_by_unit()
        self._unit_memo[key] = (prog, windows, busy)
        return windows, busy

    def stream(self, overlay: int, kind: str, prog, t0: int, t1: int,
               model: str) -> None:
        """One charged compiled stream on an overlay: a span on the
        overlay's ``stream`` track, per-unit busy spans, and (streaming
        model) the schedule's attributed stall intervals offset to the
        engine clock.  ``[t0, t1]`` is the integer engine-clock window the
        charge occupied; span geometry is clipped into it (the clock's
        carried fractional remainder can make the window a fraction
        shorter than the scheduled float total), while ``args`` carry the
        exact scheduled values the aggregates use."""
        length = int(t1) - int(t0)
        if length <= 0:
            return
        self.charged[overlay] = self.charged.get(overlay, 0) + length
        self.events.append({
            "ph": "X", "name": kind, "cat": "stream",
            "track": ("overlay", overlay, "stream"),
            "ts": int(t0), "dur": length,
            "args": {"cycles": length, "model": model},
        })
        xfer_units = TRANSFER_UNITS.get(kind)
        if xfer_units is not None:
            # pure transfer: the whole window is unit-busy at 1 row/cycle
            for u in xfer_units:
                self.unit_busy[(overlay, u)] = \
                    self.unit_busy.get((overlay, u), 0) + length
                self.events.append({
                    "ph": "X", "name": kind, "cat": "unit",
                    "track": ("overlay", overlay, u),
                    "ts": int(t0), "dur": length,
                    "args": {"busy": length},
                })
            return
        windows, busy = self._unit_windows(prog, model)
        for u, (lo, hi) in windows.items():
            b = busy.get(u, 0)
            if b <= 0:
                continue
            s = int(t0) + min(lo, length)
            e = int(t0) + min(hi, length)
            self.unit_busy[(overlay, u)] = \
                self.unit_busy.get((overlay, u), 0) + b
            if e > s:
                self.events.append({
                    "ph": "X", "name": kind, "cat": "unit",
                    "track": ("overlay", overlay, u),
                    "ts": s, "dur": e - s,
                    "args": {"busy": b},
                })
        if model == "streaming":
            sched = schedule_for(prog, model)
            for s0, s1, key in sched.get("stall_intervals", ()):
                gap = s1 - s0
                if gap <= 0:
                    continue
                self.stalls[(overlay, key)] = \
                    self.stalls.get((overlay, key), 0.0) + gap
                s = int(t0) + min(s0, length)
                e = int(t0) + min(s1, length)
                if e > s:
                    self.events.append({
                        "ph": "X", "name": key, "cat": "stall",
                        "track": ("overlay", overlay, "stalls"),
                        "ts": s, "dur": e - s,
                        "args": {"cycles": gap, "stream": kind},
                    })

    # --- request-side emission -------------------------------------------

    def request_admitted(self, req, overlay: int) -> None:
        """Submit instant plus the queue-wait span [submit, admit]."""
        rid = req.rid
        self.events.append({
            "ph": "i", "name": "submit", "cat": "request",
            "track": ("request", rid),
            "ts": int(req.submit_cycle), "args": {},
        })
        wait = int(req.admit_cycle) - int(req.submit_cycle)
        if wait > 0:
            self.events.append({
                "ph": "X", "name": "queue", "cat": "request",
                "track": ("request", rid),
                "ts": int(req.submit_cycle), "dur": wait,
                "args": {"overlay": overlay},
            })

    def req_span(self, rid: int, name: str, t0: int, t1: int,
                 overlay: int, attributed: Optional[int] = None,
                 **extra) -> None:
        """A charged span attributed wholly to one request.

        ``attributed`` overrides the cycles charged to the request when
        the span's wall window differs from the work it covers — an
        expert phase whose tasks run on several overlays in parallel
        spans [min start, max end] but charges the sum of the placed
        task lengths."""
        length = int(t1) - int(t0)
        if length <= 0:
            return
        att = length if attributed is None else int(attributed)
        self.attributed[rid] = self.attributed.get(rid, 0) + att
        self.attr_by_name[(rid, name)] = \
            self.attr_by_name.get((rid, name), 0) + att
        args = {"attributed": att, "overlay": overlay}
        args.update(extra)
        self.events.append({
            "ph": "X", "name": name, "cat": "request",
            "track": ("request", rid),
            "ts": int(t0), "dur": length, "args": args,
        })

    def req_split(self, rids, name: str, t0: int, t1: int,
                  overlay: int, **extra) -> None:
        """A charged span shared by several requests (batched decode step,
        bank migration): every participant gets a span over the full
        window, with the integer length split exactly — floor share each,
        remainder to the lowest rids — so attributions sum to the span
        length with no rounding residue."""
        rids = sorted(rids)
        length = int(t1) - int(t0)
        if length <= 0 or not rids:
            return
        share, rem = divmod(length, len(rids))
        for j, rid in enumerate(rids):
            att = share + (1 if j < rem else 0)
            self.attributed[rid] = self.attributed.get(rid, 0) + att
            self.attr_by_name[(rid, name)] = \
                self.attr_by_name.get((rid, name), 0) + att
            args = {"attributed": att, "overlay": overlay,
                    "shared": len(rids)}
            args.update(extra)
            self.events.append({
                "ph": "X", "name": name, "cat": "request",
                "track": ("request", rid),
                "ts": int(t0), "dur": length, "args": args,
            })

    def instant(self, rid: int, name: str, ts: int, **extra) -> None:
        self.events.append({
            "ph": "i", "name": name, "cat": "request",
            "track": ("request", rid), "ts": int(ts), "args": dict(extra),
        })

    # --- aggregate views --------------------------------------------------

    def summary(self) -> dict:
        """Deterministic aggregate dict embedded in exported traces."""
        overlays = sorted(set(
            [o for o in self.charged]
            + [o for o, _ in self.unit_busy]
            + [o for o, _ in self.stalls]))
        return {
            "overlays": {
                str(o): {
                    "charged_cycles": self.charged.get(o, 0),
                    "unit_busy": {u: self.unit_busy[(o, u)]
                                  for u in UNITS if (o, u) in self.unit_busy},
                    "stalls": {k: self.stalls[(o, k)]
                               for _, k in sorted(
                                   kk for kk in self.stalls if kk[0] == o)},
                }
                for o in overlays
            },
            "requests": {
                str(rid): {
                    "attributed_cycles": self.attributed[rid],
                    "by_span": {name: self.attr_by_name[(r, name)]
                                for r, name in sorted(self.attr_by_name)
                                if r == rid},
                }
                for rid in sorted(self.attributed)
            },
        }

"""Chrome trace-event / Perfetto JSON export for the cycle-domain tracer.

A copy of `repro/npec/obs/export.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Time unit: ONE TRACE MICROSECOND == ONE OVERLAY CYCLE.  Chrome's trace
format mandates microsecond timestamps; exporting raw cycles keeps every
timestamp an exact integer (no float noise, byte-identical runs) and the
UI's "us" readout is simply cycles — ``otherData.clock_hz`` carries the
conversion (cycles / clock_hz = seconds; 200 MHz -> 1 displayed "ms" is
200k cycles).

Track layout (one Perfetto track per overlay x unit, one per request):

* pid ``1`` — the ``requests`` process; tid ``rid + 1`` per request.
* pid ``1000 + overlay`` — one process per overlay; tids: ``stream`` (the
  charged compiled streams), one per execution unit (MMU/NVU/MRU/MWU),
  and ``stalls`` (attributed stall gaps, named by stall key).

The exported dict also embeds, outside ``traceEvents``: the tracer's
exact aggregate ``summary`` (per-overlay charged/busy/stall cycles,
per-request attributions), the run ``report``, and the full metrics
``snapshot`` — so a trace file is self-contained for the profiler CLI
(`python -m repro_torch.npec.obs.profile trace.json`) and for the reconcile
gates in tests/test_npec_obs.py.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.npec.obs.tracer import Tracer, UNITS

#: tid assignment inside an overlay process (Perfetto sorts by tid).
_OVERLAY_TIDS = {"stream": 1, "MMU": 2, "NVU": 3, "MRU": 4, "MWU": 5,
                 "stalls": 6}
_REQUEST_PID = 1
_OVERLAY_PID_BASE = 1000


def _track_ids(track) -> tuple:
    if track[0] == "overlay":
        _, overlay, lane = track
        return _OVERLAY_PID_BASE + overlay, _OVERLAY_TIDS[lane]
    _, rid = track
    return _REQUEST_PID, rid + 1


def trace_to_dict(tracer: Tracer, *, clock_hz: Optional[float] = None,
                  report: Optional[dict] = None,
                  metrics: Optional[dict] = None) -> dict:
    """Render the tracer into a Chrome trace-event JSON object."""
    hz = clock_hz if clock_hz is not None else tracer.clock_hz
    events = []
    seen_pids: Dict[int, str] = {}
    seen_tids: Dict[tuple, str] = {}
    # stable order: per-track chronological, tracks by (pid, tid)
    by_track: Dict[tuple, list] = {}
    for ev in tracer.events:
        by_track.setdefault(_track_ids(ev["track"]), []).append(ev)
    for (pid, tid) in sorted(by_track):
        lane = by_track[(pid, tid)]
        track = lane[0]["track"]
        if track[0] == "overlay":
            seen_pids.setdefault(pid, f"overlay{track[1]}")
            seen_tids[(pid, tid)] = track[2]
        else:
            seen_pids.setdefault(pid, "requests")
            seen_tids[(pid, tid)] = f"req {track[1]}"
        for ev in sorted(lane, key=lambda e: (e["ts"],
                                              e.get("dur", 0))):
            out = {"ph": ev["ph"], "name": ev["name"], "cat": ev["cat"],
                   "pid": pid, "tid": tid, "ts": ev["ts"]}
            if ev["ph"] == "X":
                out["dur"] = ev["dur"]
            if ev["ph"] == "i":
                out["s"] = "t"          # thread-scoped instant
            out["args"] = ev["args"]
            events.append(out)
    meta = []
    for pid in sorted(seen_pids):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": seen_pids[pid]}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
    for (pid, tid) in sorted(seen_tids):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": seen_tids[(pid, tid)]}})
        meta.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                     "tid": tid, "args": {"sort_index": tid}})
    out = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro.npec.obs",   # the format's id, as the reference writes it
            "clock_hz": hz,
            "time_unit": "cycles",
        },
        "summary": tracer.summary(),
    }
    if report is not None:
        out["report"] = report
    if metrics is not None:
        out["metrics"] = metrics
    return out


def dumps_trace(trace: dict) -> str:
    """Deterministic JSON text for a rendered trace dict (byte-identical
    across identical runs — the determinism gate diffs these strings)."""
    return json.dumps(trace, indent=1, sort_keys=False)


def write_chrome_trace(tracer: Tracer, path: str, **kw) -> dict:
    """Export the tracer to a Chrome/Perfetto JSON file; returns the
    trace dict (so callers can validate or profile it in-process)."""
    doc = trace_to_dict(tracer, **kw)
    with open(path, "w") as f:
        f.write(dumps_trace(doc))
        f.write("\n")
    return doc

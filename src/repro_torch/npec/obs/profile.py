"""Profiler CLI: top-k cycle sinks from an exported cycle-domain trace.

A copy of `repro/npec/obs/profile.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

    python -m repro_torch.npec.obs.profile trace.json [--top K] [--requests N]

Reads a Chrome/Perfetto JSON written by ``launch/serve.py --trace`` and
renders, entirely from the event stream (the embedded ``summary`` is
cross-checked, not trusted):

* per-overlay, per-unit utilization (busy cycles / makespan);
* the stall-budget breakdown (softmax, ln_a, gelu, ... — the same keys
  `stream_schedule` budgets);
* queue-wait vs prefill vs decode vs transfer vs migration attribution,
  fleet-wide and for the top-N slowest requests.

All numbers are integer cycles (or exact scheduled floats); converting
to wall time uses ``otherData.clock_hz``, never the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

from repro_torch.npec.obs.schema import ATTR_CATEGORY, SPAN_QUEUE, validate_trace


def analyze(trace: dict) -> dict:
    """Recompute aggregates from the raw event stream.

    Returns ``{"makespan", "clock_hz", "overlays": {overlay: {"charged",
    "units": {unit: busy}, "stalls": {key: cycles}, "idle"}},
    "requests": {rid: {"queue_wait", "categories": {cat: cycles},
    "attributed", "first_ts", "last_ts"}}, "fleet": {...totals...}}``.

    Per-overlay ``idle`` is ``makespan - charged`` (integer-exact: both
    come from the same integer clock); per-unit idle is
    ``makespan - busy - stalls`` — the conservation identity the tests
    gate."""
    names: Dict[int, str] = {}
    threads: Dict[tuple, str] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "M":
            continue
        if ev["name"] == "process_name":
            names[ev["pid"]] = ev["args"]["name"]
        elif ev["name"] == "thread_name":
            threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]

    overlays: Dict[int, dict] = {}
    requests: Dict[int, dict] = {}
    makespan = 0.0
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        end = ev["ts"] + ev.get("dur", 0)
        makespan = max(makespan, end)
        pname = names.get(ev["pid"], "")
        if pname.startswith("overlay"):
            o = int(pname[len("overlay"):])
            st = overlays.setdefault(
                o, {"charged": 0, "units": {}, "stalls": {}})
            lane = threads.get((ev["pid"], ev["tid"]), "")
            if lane == "stream" and ph == "X":
                st["charged"] += ev["dur"]
            elif lane == "stalls" and ph == "X":
                st["stalls"][ev["name"]] = (
                    st["stalls"].get(ev["name"], 0.0)
                    + ev["args"]["cycles"])
            elif ph == "X" and "busy" in ev.get("args", {}):
                st["units"][lane] = (st["units"].get(lane, 0)
                                     + ev["args"]["busy"])
        elif pname == "requests":
            lane = threads.get((ev["pid"], ev["tid"]), "req ?")
            rid = int(lane.split()[-1])
            st = requests.setdefault(
                rid, {"queue_wait": 0, "categories": {}, "attributed": 0,
                      "first_ts": ev["ts"], "last_ts": end})
            st["first_ts"] = min(st["first_ts"], ev["ts"])
            st["last_ts"] = max(st["last_ts"], end)
            if ph != "X":
                continue
            if ev["name"] == SPAN_QUEUE:
                st["queue_wait"] += ev["dur"]
            else:
                cat = ATTR_CATEGORY.get(ev["name"], ev["name"])
                att = ev["args"].get("attributed", ev["dur"])
                st["categories"][cat] = st["categories"].get(cat, 0) + att
                st["attributed"] += att

    for st in overlays.values():
        st["idle"] = makespan - st["charged"]
        st["unit_idle"] = {
            u: makespan - busy - (sum(st["stalls"].values())
                                  if u == "MMU" else 0)
            for u, busy in st["units"].items()}

    fleet = {"queue_wait": sum(r["queue_wait"] for r in requests.values()),
             "categories": {}, "attributed": 0}
    for r in requests.values():
        fleet["attributed"] += r["attributed"]
        for cat, v in r["categories"].items():
            fleet["categories"][cat] = fleet["categories"].get(cat, 0) + v

    return {
        "makespan": makespan,
        "clock_hz": trace.get("otherData", {}).get("clock_hz", 200e6),
        "overlays": overlays,
        "requests": requests,
        "fleet": fleet,
    }


def _fmt_cycles(c: float, hz: float) -> str:
    return f"{c:,.0f} cyc ({1e3 * c / hz:.3f} ms)"


def render(analysis: dict, *, top: int = 10, n_requests: int = 5,
           out=None) -> None:
    out = out if out is not None else sys.stdout
    w = out.write
    hz = analysis["clock_hz"]
    makespan = analysis["makespan"]
    w(f"makespan: {_fmt_cycles(makespan, hz)} @ {hz / 1e6:.0f} MHz\n")

    w("\n== per-overlay unit utilization ==\n")
    for o in sorted(analysis["overlays"]):
        st = analysis["overlays"][o]
        util = st["charged"] / makespan if makespan else 0.0
        w(f"overlay{o}: charged {_fmt_cycles(st['charged'], hz)}"
          f"  [{100 * util:5.1f}% of makespan, idle "
          f"{_fmt_cycles(st['idle'], hz)}]\n")
        for u in sorted(st["units"]):
            busy = st["units"][u]
            w(f"  {u:4s} busy {busy:>12,.0f} cyc"

              f"  ({100 * busy / makespan if makespan else 0:5.1f}%)\n")
        if st["stalls"]:
            w("  stall budget:\n")
            ranked = sorted(st["stalls"].items(),
                            key=lambda kv: -kv[1])[:top]
            for key, cyc in ranked:
                w(f"    {key:12s} {cyc:>12,.1f} cyc\n")

    w("\n== fleet-wide cycle sinks (top-k) ==\n")
    sinks = dict(analysis["fleet"]["categories"])
    sinks["queue_wait"] = analysis["fleet"]["queue_wait"]
    for name, cyc in sorted(sinks.items(), key=lambda kv: -kv[1])[:top]:
        w(f"  {name:12s} {_fmt_cycles(cyc, hz)}\n")

    reqs = analysis["requests"]
    if reqs:
        w(f"\n== slowest {min(n_requests, len(reqs))} requests "
          "(by span extent) ==\n")
        ranked = sorted(reqs.items(),
                        key=lambda kv: -(kv[1]["last_ts"]
                                         - kv[1]["first_ts"]))
        for rid, st in ranked[:n_requests]:
            extent = st["last_ts"] - st["first_ts"]
            parts = {"queue_wait": st["queue_wait"], **st["categories"]}
            detail = ", ".join(
                f"{k} {v:,.0f}" for k, v in
                sorted(parts.items(), key=lambda kv: -kv[1]) if v)
            w(f"  req {rid}: {_fmt_cycles(extent, hz)}  [{detail}]\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.npec.obs.profile",
        description="Top-k cycle sinks from a cycle-domain trace")
    ap.add_argument("trace", help="trace JSON from serve.py --trace")
    ap.add_argument("--top", type=int, default=10,
                    help="sinks/stall keys to show (default 10)")
    ap.add_argument("--requests", type=int, default=5,
                    help="slowest requests to itemize (default 5)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the schema check")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    if not args.no_validate:
        errs = validate_trace(trace)
        if errs:
            for e in errs:
                print(f"schema: {e}", file=sys.stderr)
            return 1
    render(analyze(trace), top=args.top, n_requests=args.requests)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

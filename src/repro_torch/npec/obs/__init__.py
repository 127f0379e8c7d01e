"""repro_torch.npec.obs — cycle-domain observability for the serving stack.

A copy of `repro/npec/obs/__init__.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

Three pieces (docs/observability.md):

* :class:`Tracer` / :data:`NULL_TRACER` (tracer.py): cycle-stamped
  span/instant events for request lifecycles and per-overlay unit
  activity, strictly opt-in with a no-op fast path;
* :class:`MetricsRegistry` (metrics.py): counters, labeled counter
  families and exact cycle histograms — the registry behind
  ``EngineStats`` / ``FleetStats`` / ``StreamCache`` reports;
* export/schema/profile: Chrome trace-event / Perfetto JSON export
  (``launch/serve.py --trace out.json``), the event-schema checker, and
  the ``python -m repro_torch.npec.obs.profile`` cycle-sink CLI.
"""

from repro_torch.npec.obs.export import (dumps_trace, trace_to_dict,
                                   write_chrome_trace)
from repro_torch.npec.obs.metrics import Counter, CycleHistogram, MetricsRegistry
from repro_torch.npec.obs.schema import (ATTR_CATEGORY, METRIC_COUNTERS,
                                   METRIC_FAMILIES, METRIC_HISTOGRAMS,
                                   REQUEST_INSTANTS, REQUEST_SPANS,
                                   STREAM_KINDS, validate_trace)
from repro_torch.npec.obs.tracer import NULL_TRACER, NullTracer, Tracer, UNITS

__all__ = [
    "ATTR_CATEGORY", "Counter", "CycleHistogram", "METRIC_COUNTERS",
    "METRIC_FAMILIES", "METRIC_HISTOGRAMS", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "REQUEST_INSTANTS", "REQUEST_SPANS",
    "STREAM_KINDS", "Tracer", "UNITS", "dumps_trace", "trace_to_dict",
    "validate_trace", "write_chrome_trace",
]

"""repro_torch.npec.runtime — compiled-stream serving engine.

A copy of `repro/npec/runtime/__init__.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

The compiler (repro_torch.npec) turns models into overlay instruction streams;
this package *serves* from them: `NPEEngine` continuous-batches requests
over ONE batched decode stream (B slots, B-row MMU projection tiles, see
`trace_decode(batch=B)`), admits each request with a compiled prefill
pass that seeds its slot's cache banks, and clocks every step with the
`greedy_schedule` cycles of the actual compiled streams — so p50/p99
latency and tokens/sec are properties of the compiled programs at the
overlay's frequency, not of the host.

    from repro_torch.npec.runtime import NPEEngine
    eng = NPEEngine(cfg, hw, slots=8, capacity=64, params=params)
    eng.submit(prompt_tokens)
    stats = eng.run()          # EngineStats; stats.report() -> p50/p99...

Wired into `launch/serve.py --backend npec`, benchmarked by
`benchmarks/paper_tables.py::npec_serve` (record:
results/npec_serve_cycles.json), documented in docs/serving.md.
"""
from repro_torch.npec.runtime.batch import Request, RequestQueue, SlotPool
from repro_torch.npec.runtime.clock import (CycleClock, LatencyTracker,
                                      inter_token_gaps)
from repro_torch.npec.runtime.engine import (EngineStats, NPEEngine, chunk_spans,
                                       synthetic_token)
from repro_torch.npec.runtime.stream_cache import (BUCKET_FLOOR, StreamCache,
                                             StreamKey, bucket_for,
                                             decode_buckets)

__all__ = ["BUCKET_FLOOR", "CycleClock", "EngineStats", "LatencyTracker",
           "NPEEngine", "Request", "RequestQueue", "SlotPool", "StreamCache",
           "StreamKey", "bucket_for", "chunk_spans", "decode_buckets",
           "inter_token_gaps", "synthetic_token"]

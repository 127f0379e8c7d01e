"""Compiled-stream cache + length-bucketed decode lowering.

A copy of `repro/npec/runtime/stream_cache.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

The overlay never re-lowers at serving time — it loads compiled
instruction streams and re-runs them — so the serving stack wants several
compiled variants of the same model live at once: one decode stream per
capacity bucket, one prefill stream per prompt length (or slice width),
transfer stubs, and so on, shared across every engine of a fleet.
`StreamCache` is that store.  It replaces two ad-hoc dicts that grew in
the engine and the fleet:

  * the engine's `_prefill_cache`, keyed only by ``(seq, chunk)`` — a
    fleet whose engines differed in family, bits, nvu_source, or bank
    capacity would have silently collided compiled programs;
  * the fleet's `_prefill_progs` plus its hand-threaded shared
    `decode_prog`.

Every entry is keyed by a full `StreamKey` — family (the *config name*,
so two configs of one family never collide), kind, sequence/bucket,
batch, bits, nvu_source, cache_len and window flag: everything the cycle
model and the numerics depend on.  Heterogeneous fleets therefore cannot
collide structurally (tests/test_npec_buckets.py).

Length buckets
--------------
A fixed-capacity decode stream charges the full capacity-T QK^T at every
position — at pos 3 of a 512-capacity stream the (g, T) attention tile
pays 512 key columns for 4 valid ones.  `decode_buckets` produces the
doubling capacity grid (64, 128, 256, ..., capacity); the engine compiles
one decode stream per bucket (through this cache) and steps each batch
against the smallest bucket covering the deepest active slot, migrating
cache banks on crossings (`DecodeSession.migrate`).  Decode-step cycles
at positions <= 64 drop >= 2x vs the capacity-512 stream on bert_base
(results/npec_buckets_cycles.json) while tokens stay identical to the
fixed-capacity engine — trailing bank rows are inert under the
pos-masked softmax, so copying the leading min(T_old, T_new) rows is
exact.

A sliding-*window* stream (`window=True` keys) is the degenerate case:
one bucket of capacity W whose `cache_append` wraps (ring writes at
pos % W) — the smallest bucket that never grows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.npec.lower import CompiledProgram
from repro_torch.npec.obs.metrics import MetricsRegistry

# the default doubling grid starts here: one 128-PE-row MMU tile holds 64
# key columns of a 16-bit (g, T) QK^T on both sides of the paper's
# geometry, and the npec_buckets acceptance gate reads "positions <= 64"
BUCKET_FLOOR = 64


@dataclass(frozen=True)
class StreamKey:
    """Full identity of a compiled stream — everything the cycle model
    and the numerics depend on.  `family` is the *config name*
    (`cfg.name`), not the family string, so two configs of one family
    (bert_base vs bert_large) can never collide; dims-only shape streams
    pass a synthesized name."""
    family: str
    kind: str              # "decode" | "prefill" | "prefill_chunk" | ...
    seq: int               # decode: bucket capacity; prefill: prompt rows
    batch: int
    bits: int
    nvu_source: str
    cache_len: Optional[int] = None   # chunked-prefill bank capacity
    window: bool = False              # ring (sliding-window) decode bank


class StreamCache:
    """Memoized compiled-program store keyed by `StreamKey`, with
    hit/miss counters surfaced in engine and fleet reports.  One instance
    can back any number of engines (a fleet shares one), because the key
    carries the full compile identity."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._progs: Dict[StreamKey, CompiledProgram] = {}
        # hit/miss counters live in a MetricsRegistry (repro_torch.npec.obs) so
        # one snapshot covers cache behavior alongside the engine's own
        # counters; `hits`/`misses` stay readable as plain attributes
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    @property
    def hits(self) -> int:
        return int(self.metrics.value("stream_cache_hits"))

    @property
    def misses(self) -> int:
        return int(self.metrics.value("stream_cache_misses"))

    def get(self, key: StreamKey,
            build: Callable[[], CompiledProgram]) -> CompiledProgram:
        """Return the cached program for `key`, compiling via `build()`
        on first use."""
        if not isinstance(key, StreamKey):
            raise TypeError(
                f"stream cache keys must be StreamKey, got {type(key)!r}")
        prog = self._progs.get(key)
        if prog is not None:
            self.metrics.inc("stream_cache_hits")
            return prog
        self.metrics.inc("stream_cache_misses")
        prog = build()
        self._progs[key] = prog
        return prog

    def __len__(self) -> int:
        return len(self._progs)

    def __contains__(self, key: StreamKey) -> bool:
        return key in self._progs

    def keys(self) -> Iterable[StreamKey]:
        return self._progs.keys()

    def report(self) -> Dict[str, int]:
        return {"stream_cache_entries": len(self._progs),
                "stream_cache_hits": self.hits,
                "stream_cache_misses": self.misses}


def decode_buckets(capacity: int,
                   seq_buckets=None,
                   floor: int = BUCKET_FLOOR) -> Tuple[int, ...]:
    """The decode capacity grid for a `capacity`-token engine.

    * seq_buckets=None   -> ``(capacity,)``: one fixed-capacity stream,
      the pre-bucketing engine behavior (committed serve/fleet records
      stay on this default);
    * seq_buckets="auto" -> the doubling grid ``floor, 2*floor, ...``
      capped at `capacity` (always included as the last bucket);
    * an explicit sequence -> validated ascending unique buckets; a
      trailing `capacity` bucket is appended if missing so every
      admissible position has a covering stream.
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if seq_buckets is None:
        return (capacity,)
    if seq_buckets == "auto":
        out = []
        b = floor
        while b < capacity:
            out.append(b)
            b *= 2
        out.append(capacity)
        return tuple(out)
    buckets = [int(b) for b in seq_buckets]
    if not buckets:
        raise ValueError("seq_buckets must not be empty")
    if any(b < 1 for b in buckets):
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    if sorted(set(buckets)) != buckets:
        raise ValueError(
            f"seq_buckets must be strictly ascending, got {buckets}")
    if buckets[-1] > capacity:
        raise ValueError(
            f"bucket {buckets[-1]} exceeds the engine capacity {capacity}")
    if buckets[-1] != capacity:
        buckets.append(capacity)
    return tuple(buckets)


def bucket_for(buckets: Sequence[int], need: int) -> int:
    """The smallest bucket covering `need` cache rows (`need` = deepest
    active position + 1: `cache_append` writes at pos, so the bank must
    hold pos + 1 rows)."""
    for b in buckets:
        if b >= need:
            return b
    raise ValueError(
        f"no bucket in {tuple(buckets)} covers {need} cache rows")

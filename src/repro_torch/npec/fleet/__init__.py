"""repro_torch.npec.fleet — cycle-accurate multi-overlay fleet simulator.

A copy of `repro/npec/fleet/__init__.py` in the port, which imports nothing of the reference
package.  Cycles, and the milliseconds derived from them, are the FPGA
overlay model's at its 200 MHz clock, never time on the card.

N NPE overlays serve one admission queue on a common fleet clock, either
as plain replicas (one `NPEEngine` per overlay) or with one model's
compiled streams *sharded* across them — expert-parallel MoE,
pipeline-parallel layer groups, prefill/decode disaggregation with
KV caches shipped between overlays, and tensor-parallel column-carved
projections with cycle-charged all-reduces — with inter-overlay transfers
charged as MRU/MWU traffic instructions
(`repro_torch.npec.lower.make_transfer`).  See
docs/fleet.md for the queue/clock/sharding semantics and
results/npec_fleet_cycles.json for the guarded benchmark record.
"""
from repro_torch.npec.fleet.partition import (ExpertPlan, Phase, PipelinePlan,
                                        PrefillDecodePlan, ShardTask,
                                        TensorPlan, instr_layer,
                                        partition_expert, partition_pipeline,
                                        partition_prefill_decode,
                                        partition_tensor)
from repro_torch.npec.fleet.sim import (FleetStats, NPEFleet, OverlayTimeline,
                                  SHARD_STRATEGIES, SharedAdmissionQueue)

__all__ = [
    "ExpertPlan", "FleetStats", "NPEFleet", "OverlayTimeline", "Phase",
    "PipelinePlan", "PrefillDecodePlan", "SHARD_STRATEGIES", "ShardTask",
    "SharedAdmissionQueue", "TensorPlan", "instr_layer", "partition_expert",
    "partition_pipeline", "partition_prefill_decode", "partition_tensor",
]

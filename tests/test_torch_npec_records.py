"""The port rebuilds every row of the committed npec cycle records.

Each function below is the function of the same name in
`benchmarks/paper_tables.py`, with the same arguments, run on the port's
`core.cycles`, `npec`, cost-only `NPEEngine` and `NPEFleet`: the bert rows,
the dense (glm4_9b) and moe (granite_moe_1b_a400m) rows of the streaming
record, the expert-parallel granite rows of the fleet record, and the MoE
super-blocks of granite and llama4 at full config scale.  The rows must
equal the record's exactly: the cycle model is deterministic.
"""
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import pytest

from repro_torch import npec
from repro_torch.configs import get_config
from repro_torch.core import cycles as cy
from repro_torch.core.overlay import NPEHardware
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.npec.fleet import NPEFleet, partition_tensor
from repro_torch.npec.runtime import (NPEEngine, StreamCache, decode_buckets,
                                      inter_token_gaps)

RESULTS = Path(__file__).resolve().parent.parent / "results"


def npec_vs_hand(seq_lens=(64, 128, 256, 512), bits_list=(8, 16)) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    out = []
    for bits in bits_list:
        for s in seq_lens:
            sh = cy.BertShape(seq=s)
            hand = cy.schedule(cy.build_encoder_program(hw, sh, bits))
            compiled = npec.compile_bert_shape(hw, sh, bits)
            greedy = npec.greedy_schedule(compiled)
            counts = compiled.counts_by_unit()
            out.append(dict(
                seq=s, mmu_bits=bits,
                mmu_instrs=counts.get("MMU", 0), nvu_instrs=counts.get("NVU", 0),
                hand_cycles=int(hand["total_cycles"]),
                npec_cycles=int(greedy["total_cycles"]),
                npec_vs_hand_pct=round(100 * (greedy["total_cycles"] - hand["total_cycles"])
                                       / hand["total_cycles"], 2),
                mmu_util=round(greedy["mmu_util"], 3)))
    return out


def npec_decode(prefill_lens=(64, 128), new_tokens=32, bits_list=(8, 16)) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    out = []
    for bits in bits_list:
        for s in prefill_lens:
            r = cy.autoregressive_cycles(hw, cy.BertShape(seq=s), new_tokens, bits)
            out.append(dict(
                prefill_seq=s, mmu_bits=bits, new_tokens=new_tokens,
                prefill_cycles=int(r["prefill_cycles"]),
                decode_cycles=int(r["decode_cycles"]),
                cycles_per_token=int(r["cycles_per_token"]),
                decode_tok_s=round(r["decode_tok_s"], 1),
                e2e_tok_s=round(r["e2e_tok_s"], 1),
                mmu_1row_eff=round(r["mmu_efficiency"], 4)))
    return out


def npec_moe(seq_lens=(64, 128), bits_list=(8, 16)) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    out = []
    for name in ("granite_moe_1b_a400m", "llama4_maverick_400b_a17b"):
        cfg = get_config(name)
        for bits in bits_list:
            for s in seq_lens:
                r = cy.moe_layer_cycles(hw, cfg, s, bits)
                counts = r["counts"]
                out.append(dict(
                    arch=name, seq=s, mmu_bits=bits, experts=cfg.moe.num_experts,
                    top_k=cfg.moe.top_k, capacity=int(r["capacity"]),
                    super_block_cycles=int(r["super_block_cycles"]),
                    total_cycles=int(r["total_cycles"]),
                    mmu_instrs=counts.get("MMU", 0), nvu_instrs=counts.get("NVU", 0),
                    mru_instrs=counts.get("MRU", 0), mwu_instrs=counts.get("MWU", 0),
                    skinny_matmuls=int(r["skinny_matmuls"]),
                    mmu_util=round(r["mmu_util"], 3),
                    mmu_eff=round(r["mmu_efficiency"], 4)))
    return out


def npec_serve(batches=(1, 2, 4, 8), bits_list=(8, 16), cache_len=128) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    sh = cy.BertShape(seq=64)
    out = []
    for bits in bits_list:
        base = cy.batched_decode_step_cycles(hw, sh, cache_len, 1, bits)["mmu_efficiency"]
        for b in batches:
            r = cy.batched_decode_step_cycles(hw, sh, cache_len, b, bits)
            out.append(dict(
                kind="step", batch=b, mmu_bits=bits, cache_len=cache_len,
                step_cycles=int(r["total_cycles"]), dag_cycles=int(r["dag_cycles"]),
                cycles_per_token=int(r["cycles_per_token"]), tok_s=round(r["tok_s"], 1),
                mmu_row_occupancy=round(r["mmu_efficiency"], 4),
                occupancy_gain=round(r["mmu_efficiency"] / base, 2)))
    cfg = get_config("bert_base")
    for bits in bits_list:
        engine = NPEEngine(cfg, hw, slots=8, capacity=48, max_new_tokens=16, bits=bits)
        reqs = SyntheticRequests(cfg.vocab_size, max_prompt=32)
        for i in range(16):
            engine.submit(reqs.request(i), eos_id=reqs.eos_id(i))
        rep = engine.run().report()
        out.append(dict(
            kind="engine", arch="bert_base", slots=8, mmu_bits=bits,
            cycle_model=rep["cycle_model"], requests=rep["requests"],
            generated_tokens=rep["generated_tokens"],
            p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
            first_token_p50_ms=rep["first_token_p50_ms"],
            tok_s=round(rep["tokens_per_sec"], 1),
            decode_step_cycles=rep["decode_step_cycles"],
            decode_step_cycles_dag=rep["decode_step_cycles_dag"],
            mmu_row_occupancy=round(rep["mmu_row_occupancy"], 4),
            total_cycles=rep["total_cycles"], decode_steps=rep["decode_steps"],
            prefills=rep["prefills"]))
    return out


def npec_fleet(bits=16) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    out = []

    def fleet_row(rep: Dict, family: str, rate) -> Dict:
        return dict(
            family=family, shard=rep["shard"], overlays=rep["overlays"],
            rate_rps=rate, mmu_bits=bits, requests=rep["requests"],
            tokens=rep["tokens"], p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
            queue_wait_p50_ms=rep["queue_wait_p50_ms"],
            queue_wait_p99_ms=rep["queue_wait_p99_ms"],
            service_p50_ms=rep["service_p50_ms"],
            tok_s=round(rep["tokens_per_sec"], 1),
            makespan_cycles=rep["makespan_cycles"],
            transfer_cycles=rep["transfer_cycles"], overlay_util=rep["overlay_util"],
            stream_cache_entries=rep.get("stream_cache_entries", 0),
            stream_cache_hits=rep.get("stream_cache_hits", 0),
            stream_cache_misses=rep.get("stream_cache_misses", 0),
            bucket_migrations=rep.get("bucket_migrations", 0),
            migration_cycles=rep.get("migration_cycles", 0))

    cfg = get_config("bert_base")
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=24, rate_rps=8.0, clock_hz=hw.clock_hz)
    n_requests = 24
    arrive = reqs.arrival_cycles(n_requests)
    shared = StreamCache()
    for shard, n in (("replicate", 1), ("replicate", 2), ("replicate", 4),
                     ("pipeline", 2), ("pipeline", 4)):
        for rate in (None, 8.0):
            fleet = NPEFleet(cfg, hw, overlays=n, shard=shard, slots=4, capacity=48,
                             max_new_tokens=12, bits=bits, stream_cache=shared)
            for i in range(n_requests):
                fleet.submit(reqs.request(i), eos_id=reqs.eos_id(i),
                             arrival_cycle=(int(arrive[i]) if rate else 0))
            out.append(fleet_row(fleet.run().report(), "bert", rate))
    # granite: expert-parallel MoE inference over 8 prompts of 64 tokens
    gcfg = get_config("granite_moe_1b_a400m")
    seq = 64
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, gcfg.vocab_size, (seq,), np.int32) for _ in range(8)]
    inference_prog = None
    for n in (1, 2, 4):
        fleet = NPEFleet(gcfg, hw, overlays=n, shard="expert", bits=bits, seq=seq,
                         inference_prog=inference_prog)
        inference_prog = fleet.inference_prog
        for p in prompts:
            fleet.submit(p)
        out.append(fleet_row(fleet.run().report(), "moe", None))
    return out


def npec_tensor(bits=16) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    cfg = get_config("bert_base")
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=24)
    slots, capacity, seq = 4, 48, 24
    dec = npec.compile_decode(cfg, capacity, hw, bits=bits, batch=slots)
    pre = npec.compile_prefill(cfg, seq, hw, bits=bits)
    shared = StreamCache()

    def critical(plan):
        costs = [(npec.stream_schedule(p)["total_cycles"], npec.transfer_cycles(p))
                 for p in plan.shards]
        return int(max(c for c, _ in costs)), int(max(x for _, x in costs))

    out = []
    for n in (1, 2, 4):
        fleet = NPEFleet(cfg, hw, overlays=n, shard="tensor", slots=slots,
                         capacity=capacity, max_new_tokens=12, bits=bits,
                         stream_cache=shared)
        for i in range(4):
            fleet.submit(reqs.request(i), eos_id=reqs.eos_id(i))
        rep = fleet.run().report()
        dplan, pplan = partition_tensor(dec, n), partition_tensor(pre, n)
        d_cyc, d_xfer = critical(dplan)
        p_cyc, p_xfer = critical(pplan)
        out.append(dict(
            family="bert", shard="tensor", overlays=n, mmu_bits=bits,
            heads_per_overlay=cfg.num_heads // n, boundaries=dplan.boundaries,
            requests=rep["requests"], tokens=rep["tokens"],
            p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
            service_p50_ms=rep["service_p50_ms"], tok_s=round(rep["tokens_per_sec"], 1),
            makespan_cycles=rep["makespan_cycles"], transfer_cycles=rep["transfer_cycles"],
            overlay_util=rep["overlay_util"], decode_step_cycles=d_cyc,
            decode_allreduce_cycles=d_xfer, prefill_cycles=p_cyc,
            prefill_allreduce_cycles=p_xfer))
    return out


def npec_disagg(bits=16) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    cfg = get_config("bert_base")
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=32, rate_rps=8.0, clock_hz=hw.clock_hz)
    n_requests = 24
    arrive = reqs.arrival_cycles(n_requests)
    shared = StreamCache()
    ms = lambda c: round(1e3 * float(c) / hw.clock_hz, 4)  # noqa: E731
    out = []
    for shard, chunk in (("replicate", None), ("replicate", 8),
                         ("prefill_decode", None), ("prefill_decode", 8)):
        fleet = NPEFleet(cfg, hw, overlays=2, shard=shard, slots=4, capacity=48,
                         max_new_tokens=12, bits=bits, stream_cache=shared,
                         prefill_chunk=chunk, prefill_overlays=1)
        for i in range(n_requests):
            fleet.submit(reqs.request(i), eos_id=reqs.eos_id(i), arrival_cycle=int(arrive[i]))
        stats = fleet.run()
        rep = stats.report()
        gaps = np.asarray(inter_token_gaps(stats.requests))
        first = [r.first_token_cycle - r.submit_cycle for r in stats.requests]
        out.append(dict(
            shard=shard, overlays=2,
            prefill_overlays=(1 if shard == "prefill_decode" else 0),
            prefill_chunk=(chunk if chunk is not None else 0),
            rate_rps=8.0, mmu_bits=bits, requests=rep["requests"], tokens=rep["tokens"],
            p99_ms=rep["p99_ms"], first_token_p50_ms=ms(np.percentile(first, 50)),
            decode_gap_p99_ms=(ms(np.percentile(gaps, 99)) if gaps.size else 0.0),
            decode_gap_max_ms=(ms(gaps.max()) if gaps.size else 0.0),
            tok_s=round(rep["tokens_per_sec"], 1), makespan_cycles=rep["makespan_cycles"],
            transfer_cycles=rep["transfer_cycles"],
            kv_rows_per_token=(fleet.disagg_plan.kv_rows_per_token
                               if fleet.disagg_plan else 0),
            decode_steps=rep["decode_steps"], prefills=rep["prefills"]))
    return out


def npec_buckets(bits=16) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    sh = cy.BertShape(seq=64)
    batch = 16
    out = []
    buckets = decode_buckets(512, "auto")
    base = cy.batched_decode_step_cycles(hw, sh, buckets[-1], batch, bits)
    for bkt in buckets:
        r = cy.batched_decode_step_cycles(hw, sh, bkt, batch, bits)
        out.append(dict(
            kind="step", mode="bucketed", bucket=bkt, batch=batch, mmu_bits=bits,
            step_cycles=int(r["total_cycles"]), cycles_per_token=int(r["cycles_per_token"]),
            tok_s=round(r["tok_s"], 1),
            saving_vs_capacity=round(base["total_cycles"] / r["total_cycles"], 2)))
    rw = cy.batched_decode_step_cycles(hw, sh, 64, batch, bits, window=True)
    out.append(dict(
        kind="step", mode="window", bucket=64, batch=batch, mmu_bits=bits,
        step_cycles=int(rw["total_cycles"]), cycles_per_token=int(rw["cycles_per_token"]),
        tok_s=round(rw["tok_s"], 1),
        saving_vs_capacity=round(base["total_cycles"] / rw["total_cycles"], 2)))
    cfg = get_config("bert_base")
    for mode, sb in (("fixed", None), ("bucketed", "auto")):
        eng = NPEEngine(cfg, hw, slots=8, capacity=512, max_new_tokens=16, bits=bits,
                        seq_buckets=sb)
        reqs = SyntheticRequests(cfg.vocab_size, max_prompt=32)
        for i in range(16):
            eng.submit(reqs.request(i), eos_id=reqs.eos_id(i))
        rep = eng.run().report()
        out.append(dict(
            kind="engine", arch="bert_base", mode=mode, slots=8, capacity=512,
            mmu_bits=bits, seq_buckets=rep["seq_buckets"],
            decode_steps=rep["decode_steps"],
            decode_steps_by_bucket=rep["decode_steps_by_bucket"],
            bucket_migrations=rep["bucket_migrations"],
            migration_cycles=rep["migration_cycles"], total_cycles=rep["total_cycles"],
            tok_s=round(rep["tokens_per_sec"], 1), p99_ms=rep["p99_ms"],
            stream_cache_entries=rep["stream_cache_entries"],
            stream_cache_hits=rep["stream_cache_hits"],
            stream_cache_misses=rep["stream_cache_misses"]))
    return out


def npec_stream(seq=64, bits_list=(8, 16), decode_batches=(1, 4, 8)) -> List[Dict]:
    hw = NPEHardware(vrwidth=1024)
    out = []
    for fam, arch in (("bert", "bert_base"), ("dense", "glm4_9b"),
                      ("moe", "granite_moe_1b_a400m")):
        cfg = get_config(arch)
        layers = cfg.moe.interleave if cfg.moe is not None else 1
        for bits in bits_list:
            compiled = npec.compile_model(cfg, seq, hw, bits=bits, layers=layers,
                                          include_embed=False)
            dag = npec.greedy_schedule(compiled)
            st = npec.stream_schedule(compiled)
            out.append(dict(
                kind="prefill", family=fam, arch=arch, seq=seq, mmu_bits=bits,
                layers=layers, dag_cycles=int(dag["total_cycles"]),
                streaming_cycles=int(st["total_cycles"]),
                streaming_saving_pct=round(100 * (dag["total_cycles"] - st["total_cycles"])
                                           / dag["total_cycles"], 2),
                mmu_busy=int(st["mmu_busy"]), stall_cycles=int(sum(st["stalls"].values()))))
    sh = cy.BertShape(seq=seq)
    for bits in bits_list:
        for b in decode_batches:
            r = cy.batched_decode_step_cycles(hw, sh, 128, b, bits)
            out.append(dict(
                kind="decode", family="bert", arch="bert_base", batch=b, mmu_bits=bits,
                cache_len=128, dag_cycles=int(r["dag_cycles"]),
                streaming_cycles=int(r["streaming_cycles"]),
                streaming_saving_pct=round(100 * (r["dag_cycles"] - r["streaming_cycles"])
                                           / r["dag_cycles"], 2),
                tok_s=round(r["tok_s"], 1), mmu_row_occupancy=round(r["mmu_efficiency"], 4)))
    return out


RECORDS = {
    "npec_cycles.json": ("npec_cycles/v1", npec_vs_hand),
    "npec_decode_cycles.json": ("npec_decode_cycles/v1", npec_decode),
    "npec_moe_cycles.json": ("npec_moe_cycles/v1", npec_moe),
    "npec_serve_cycles.json": ("npec_serve_cycles/v1", npec_serve),
    "npec_stream_cycles.json": ("npec_stream_cycles/v1", npec_stream),
    "npec_fleet_cycles.json": ("npec_fleet_cycles/v1", npec_fleet),
    "npec_tensor_cycles.json": ("npec_tensor_cycles/v1", npec_tensor),
    "npec_disagg_cycles.json": ("npec_disagg_cycles/v1", npec_disagg),
    "npec_buckets_cycles.json": ("npec_buckets_cycles/v1", npec_buckets),
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_port_rebuilds_bert_rows_of_record(name):
    schema, build = RECORDS[name]
    record = json.loads((RESULTS / name).read_text())
    assert record["schema"] == schema
    want = record["rows"]
    assert want, f"{name} has no rows"
    assert build() == want

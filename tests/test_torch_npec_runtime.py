"""The port's serving runtime, cycle model, observability and fleet against
the reference's, on the CPU.

The smoke BERT (2 layers, width 128, GQA 4q/2kv) in float32; numeric
engines take the reference's `registry.init_params` weights through
`param_tree_from_jax` and run with device="cpu", where the executor's kernel
wrappers run their plain versions.

  * `core/cycles.py`: every public function gives the reference's numbers
    exactly over a grid (VRWIDTH 256-2048, seq 64-512, bits 8/16, decode
    cache lengths and batches, chunked prefill, the paper tables);
  * cost-only `NPEEngine` / `NPEFleet`: reports, snapshots, per-request
    stamps and Chrome traces equal the reference's, key for key and byte
    for byte;
  * numeric `NPEEngine` (float, NPE-8, NPE-16): the reference engine's
    tokens.  A token may differ only at a near tie: the reference's own
    top-2 logit margin at that step must be below the mode's tolerance
    (NPE 5e-3, tests/conftest.py; float 5e-6, the reference's own float
    noise measured in tests/test_torch_npec_exec.py), else the test fails.
    The engine also equals the port's per-sequence rollout, and chunked
    prefill the whole-prompt engine;
  * `shard_tile`: the reference's results wherever it returns one, and a
    `ValueError` for a zero-column shard, where the reference divides by
    zero.
"""
import argparse
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import cycles as rcy  # noqa: E402
from repro.core.overlay import NPEHardware as RefHW  # noqa: E402
from repro.data.pipeline import SyntheticRequests as RefRequests  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.npec import fleet as rfleet  # noqa: E402
from repro.npec import obs as robs  # noqa: E402
from repro.npec.runtime import NPEEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import cycles as pcy  # noqa: E402
from repro_torch.core.overlay import NPEHardware as PortHW  # noqa: E402
from repro_torch.data.pipeline import SyntheticRequests  # noqa: E402
from repro_torch.models.convert import param_tree_from_jax  # noqa: E402
from repro_torch.npec import fleet as pfleet  # noqa: E402
from repro_torch.npec import obs as pobs  # noqa: E402
from repro_torch.npec.obs.profile import analyze  # noqa: E402
from repro_torch.npec.runtime import NPEEngine  # noqa: E402
from repro_torch.npec.trace import CompileError  # noqa: E402

NPE_TOL = 5e-3
FLOAT_TOL = 5e-6
MODES = {"float": (False, 16), "npe8": (True, 8), "npe16": (True, 16)}
RHW, PHW = RefHW(vrwidth=1024), PortHW(vrwidth=1024)


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _cfgs(**over):
    ref = dataclasses.replace(ref_config("bert_base", smoke=True), dtype="float32", **over)
    port = dataclasses.replace(port_config("bert_base", smoke=True), dtype="float32", **over)
    return ref, port


def _submit(engine, n, max_prompt, vocab, **kw):
    reqs = SyntheticRequests(vocab, max_prompt=max_prompt, **kw)
    arrive = reqs.arrival_cycles(n)
    for i in range(n):
        if isinstance(engine, (pfleet.NPEFleet, rfleet.NPEFleet)):
            engine.submit(reqs.request(i), eos_id=reqs.eos_id(i),
                          arrival_cycle=int(arrive[i]))
        else:
            engine.submit(reqs.request(i), eos_id=reqs.eos_id(i))


def _stamps(stats):
    return {r.rid: (list(r.generated), r.submit_cycle, r.admit_cycle,
                    r.first_token_cycle, r.finish_cycle, list(r.token_cycles))
            for r in stats.requests}


# ---------------------------------------------------------------------------
# data/pipeline.py: eos ids and arrival cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(0, None), (0, 8.0), (3, 2.5), (11, 40.0)])
def test_synthetic_requests_match_reference(seed, rate):
    ref = RefRequests(30522, max_prompt=32, seed=seed, rate_rps=rate)
    port = SyntheticRequests(30522, max_prompt=32, seed=seed, rate_rps=rate)
    for i in range(20):
        assert np.array_equal(port.request(i), ref.request(i))
        assert port.eos_id(i) == ref.eos_id(i)
    assert np.array_equal(port.arrival_cycles(24), ref.arrival_cycles(24))


# ---------------------------------------------------------------------------
# core/cycles.py: the same numbers, exactly
# ---------------------------------------------------------------------------

VRS = (256, 512, 1024, 2048)


@pytest.mark.parametrize("vr", VRS)
@pytest.mark.parametrize("bits", (8, 16))
def test_cycles_encoder_grid(vr, bits):
    """Hand-built program, its DAG schedule (with and without overlap), the
    analytic streaming model, both charges, the npec DAG backend, and the
    time and throughput wrappers, at seq 64-512."""
    for seq in (64, 128, 256, 512):
        for overlap in (True, False):
            a = rcy.build_encoder_program(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits,
                                          overlap=overlap)
            b = pcy.build_encoder_program(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits,
                                          overlap=overlap)
            assert [dataclasses.astuple(i) for i in a.instrs] == \
                [dataclasses.astuple(i) for i in b.instrs]
            assert rcy.schedule(a) == pcy.schedule(b)
        for kw in (dict(), dict(model="dag"), dict(overlap=False, model="dag"),
                   dict(charge="padded"), dict(backend="npec", model="dag"),
                   dict(nvu_source="model")):
            assert rcy.inference_cycles(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits, **kw) \
                == pcy.inference_cycles(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits, **kw)
        assert rcy.inference_time_ms(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits) \
            == pcy.inference_time_ms(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits)
        assert rcy.throughput_inf_s(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits) \
            == pcy.throughput_inf_s(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits)


@pytest.mark.parametrize("vr,seq", [(256, 64), (1024, 64), (1024, 128), (2048, 128),
                                    (512, 256)])
@pytest.mark.parametrize("bits", (8, 16))
def test_cycles_npec_streaming_backend(vr, seq, bits):
    kw = dict(backend="npec")
    assert rcy.inference_cycles(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits, **kw) \
        == pcy.inference_cycles(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits, **kw)
    ra = rcy.build_encoder_program(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits,
                                   backend="npec")
    pa = pcy.build_encoder_program(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits,
                                   backend="npec")
    assert rcy.schedule(ra) == pcy.schedule(pa)


@pytest.mark.parametrize("cycle_model", ("streaming", "dag"))
@pytest.mark.parametrize("bits", (8, 16))
def test_cycles_decode_grid(cycle_model, bits):
    """Decode steps over cache lengths, merged batches (and the ring), and
    chunked prefill, autoregressive serving and pipeline stages."""
    r, p = (RefHW(vrwidth=1024), rcy.BertShape(seq=64)), (PortHW(vrwidth=1024),
                                                       pcy.BertShape(seq=64))
    for T in (16, 64, 128, 256):
        assert rcy.decode_step_cycles(*r, T, bits, cycle_model=cycle_model) \
            == pcy.decode_step_cycles(*p, T, bits, cycle_model=cycle_model)
        for B in (1, 2, 4, 8, 16):
            for window in (False, True):
                assert rcy.batched_decode_step_cycles(
                    *r, T, B, bits, cycle_model=cycle_model, window=window) \
                    == pcy.batched_decode_step_cycles(
                        *p, T, B, bits, cycle_model=cycle_model, window=window)
    for seq, chunk, cap in ((64, 16, None), (64, 64, None), (100, 32, 128),
                            (128, 8, 256)):
        assert rcy.chunked_prefill_cycles(*r, seq, chunk, bits, cycle_model=cycle_model,
                                          capacity=cap) \
            == pcy.chunked_prefill_cycles(*p, seq, chunk, bits, cycle_model=cycle_model,
                                          capacity=cap)
    for seq, new in ((64, 32), (128, 32), (64, 8)):
        assert rcy.autoregressive_cycles(r[0], rcy.BertShape(seq=seq), new, bits,
                                         cycle_model=cycle_model) \
            == pcy.autoregressive_cycles(p[0], pcy.BertShape(seq=seq), new, bits,
                                         cycle_model=cycle_model)
    for stages in (1, 2, 4):
        assert rcy.pipeline_stage_cycles(r[0], rcy.BertShape(seq=64, encoders=4), 48, 4,
                                         bits, stages, cycle_model=cycle_model) \
            == pcy.pipeline_stage_cycles(p[0], pcy.BertShape(seq=64, encoders=4), 48, 4,
                                         bits, stages, cycle_model=cycle_model)


@pytest.mark.parametrize("vr", VRS)
def test_cycles_paper_tables(vr):
    """Table 2, Table 4, Fig 5 and Table 7's inputs, as tests/test_cycles.py
    reads them."""
    for seq in (64, 128, 256, 512):
        for bits in (8, 16):
            assert rcy.throughput_requirements(RefHW(vrwidth=vr), rcy.BertShape(seq=seq), bits) \
                == pcy.throughput_requirements(PortHW(vrwidth=vr), pcy.BertShape(seq=seq), bits)
    for bits in (8, 16):
        assert rcy.optimized_requirements(RefHW(vrwidth=vr), bits=bits) \
            == pcy.optimized_requirements(PortHW(vrwidth=vr), bits=bits)
    assert pcy.throughput_requirements(PortHW(vrwidth=1024), pcy.BertShape(seq=512),
                                       16)["softmax"]["budget"] == 8192


def test_cycles_moe_functions_raise_compile_error():
    """The MoE cycle functions give the reference's numbers, key for key,
    for granite and llama4 (smoke); what raises `CompileError` is only the
    MoE decode stream, in both packages (the reference compiles none)."""
    for name in ("granite_moe_1b_a400m", "llama4_maverick_400b_a17b"):
        ref, port = ref_config(name, smoke=True), port_config(name, smoke=True)
        for seq, bits in ((16, 16), (24, 8)):
            assert pcy.moe_layer_cycles(PHW, port, seq, bits) == \
                rcy.moe_layer_cycles(RHW, ref, seq, bits)
            for n in (1, 2):
                assert pcy.expert_shard_cycles(PHW, port, seq, bits, n) == \
                    rcy.expert_shard_cycles(RHW, ref, seq, bits, n)
        with pytest.raises(CompileError, match="MoE decode streams"):
            tn.compile_decode(port, 16, PHW)


# ---------------------------------------------------------------------------
# Cost-only engine: reports, snapshots and stamps key for key
# ---------------------------------------------------------------------------

ENGINE_VARIANTS = {
    "fixed": (dict(capacity=24), 12),
    "buckets_auto": (dict(capacity=160, seq_buckets="auto"), 100),
    "buckets_list": (dict(capacity=96, seq_buckets=(16, 48)), 60),
    "window": (dict(capacity=24, window=16), 12),
    "chunk1": (dict(capacity=24, prefill_chunk=1), 12),
    "chunk4": (dict(capacity=24, prefill_chunk=4), 12),
}


def _cost_engines(variant, cycle_model, tracers=(None, None)):
    kw, max_prompt = ENGINE_VARIANTS[variant]
    ref_cfg, port_cfg = _cfgs()
    out = []
    for Engine, cfg, hw, tr in ((RefEngine, ref_cfg, RHW, tracers[0]),
                                (NPEEngine, port_cfg, PHW, tracers[1])):
        eng = Engine(cfg, hw, slots=2, max_new_tokens=6, cycle_model=cycle_model,
                     tracer=tr, **kw)
        _submit(eng, 8, max_prompt, cfg.vocab_size)
        out.append(eng.run())
    return out


@pytest.mark.parametrize("cycle_model", ("streaming", "dag"))
@pytest.mark.parametrize("variant", sorted(ENGINE_VARIANTS))
def test_cost_only_engine_matches_reference(variant, cycle_model):
    ref, port = _cost_engines(variant, cycle_model)
    assert port.report() == ref.report()
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(ref.snapshot(), sort_keys=True)
    assert _stamps(port) == _stamps(ref)


def test_cost_only_engine_allocates_no_tensor(monkeypatch):
    """params=None touches no device: no torch tensor is ever built."""
    def refuse(*a, **k):
        raise AssertionError("a cost-only engine made a tensor")
    for name in ("zeros", "as_tensor", "tensor", "from_numpy", "empty"):
        monkeypatch.setattr(torch, name, refuse)
    _, port_cfg = _cfgs()
    eng = NPEEngine(port_cfg, PHW, slots=2, capacity=24, max_new_tokens=4,
                    prefill_chunk=4)
    _submit(eng, 4, 12, port_cfg.vocab_size)
    assert eng.run().report()["generated_tokens"] > 0


def test_engine_families_raise_compile_error():
    """An engine serves what the compiler can decode: a moe config, or a
    BERT-shaped config with learned positions traced as a decoder, raises
    the reference's `CompileError` at construction."""
    ref_cfg, port_cfg = _cfgs()
    cases = [lambda c: dataclasses.replace(c, family="dense"),
             lambda c: dataclasses.replace(c, family="moe")]
    for case in cases:
        msgs = []
        for Engine, cfg, hw, err in ((RefEngine, ref_cfg, RHW, rn.CompileError),
                                     (NPEEngine, port_cfg, PHW, CompileError)):
            with pytest.raises(err) as e:
                Engine(case(cfg), hw, slots=2, capacity=24)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_numeric_engine_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, port_cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        NPEEngine(port_cfg, PHW, slots=2, capacity=24, params={})


# ---------------------------------------------------------------------------
# Numeric engine on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    ref_cfg, port_cfg = _cfgs()
    params = registry.init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = param_tree_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return ref_cfg, port_cfg, params, tree


NUMERIC = dict(slots=4, capacity=32, max_new_tokens=6)
N_REQ, MAX_PROMPT = 6, 12       # 6 requests on 4 slots: slots are recycled


def _port_engine(port_cfg, tree, mode, **kw):
    npe, bits = MODES[mode]
    eng = NPEEngine(port_cfg, PHW, bits=bits, npe=npe, params=tree, device="cpu",
                    **{**NUMERIC, **kw})
    _submit(eng, N_REQ, MAX_PROMPT, port_cfg.vocab_size)
    return eng.run()


_REF_RUNS = {}


def _ref_engine(weights, mode):
    if mode not in _REF_RUNS:
        ref_cfg, _, params, _ = weights
        npe, bits = MODES[mode]
        eng = RefEngine(ref_cfg, RHW, bits=bits, npe=npe, params=params, **NUMERIC)
        _submit(eng, N_REQ, MAX_PROMPT, ref_cfg.vocab_size)
        _REF_RUNS[mode] = eng.run()
    return _REF_RUNS[mode]


def _ref_margin(weights, mode, tokens) -> float:
    """The reference's top-2 logit margin for the token after `tokens`: its
    causal serving prefill over them, the logits of the last row."""
    ref_cfg, _, params, _ = weights
    npe, bits = MODES[mode]
    prog = rn.compile_prefill(ref_cfg, len(tokens), RHW, bits=bits)
    logits = np.asarray(rn.execute(
        prog, params, {"tokens": np.asarray(tokens, np.int32)},
        cfg=ref_cfg.with_npe(quant_bits=bits) if npe else None)[0])[-1]
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_numeric_engine_serves_reference_tokens(weights, mode):
    ref = _ref_engine(weights, mode)
    port = _port_engine(weights[1], weights[3], mode)
    tol = NPE_TOL if MODES[mode][0] else FLOAT_TOL
    want = {r.rid: r for r in ref.requests}
    assert sorted(want) == sorted(r.rid for r in port.requests)
    for r in port.requests:
        a, b = want[r.rid].generated, r.generated
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == min(len(a), len(b)) or a[i] != b[i])
        margin = _ref_margin(weights, mode, list(r.prompt) + a[:j])
        assert margin < tol, (
            f"request {r.rid} token {j}: port {b[j:j + 1]} vs reference {a[j:j + 1]} "
            f"with the reference's top-2 margin {margin:.3g} >= {tol:g}: not a near tie")
    if all(want[r.rid].generated == r.generated for r in port.requests):
        assert port.report() == ref.report()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_numeric_engine_matches_per_sequence_rollout(weights, mode):
    """Compiled prefill + the batched decode stream give the tokens of a
    per-sequence decode stream rolled out token by token (the reference's
    test_engine_matches_per_sequence_rollout, for every request)."""
    _, port_cfg, _, tree = weights
    npe, bits = MODES[mode]
    stats = _port_engine(port_cfg, tree, mode)
    npe_cfg = port_cfg.with_npe(quant_bits=bits) if npe else None
    prog = tn.compile_decode(port_cfg, NUMERIC["capacity"], PHW, bits=bits)
    for r in stats.requests:
        sess = tn.DecodeSession(prog, tree, cfg=npe_cfg, device="cpu")
        for t in range(len(r.prompt)):
            out = sess.step(torch.as_tensor(r.prompt[t:t + 1][None]))
        want = [int(torch.argmax(out[0, -1]))]
        while len(want) < len(r.generated):
            out = sess.step(torch.tensor([[want[-1]]], dtype=torch.int32))
            want.append(int(torch.argmax(out[0, -1])))
        assert r.generated == want, r.rid


@pytest.mark.parametrize("chunk", (1, 4))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_engine_tokens_equal_whole_prompt(weights, mode, chunk):
    """The reference's test_chunked_engine_decode_tokens_identical, in every
    mode: prompts streamed as cache slices decode the same tokens."""
    _, port_cfg, _, tree = weights
    whole = _port_engine(port_cfg, tree, mode)
    sliced = _port_engine(port_cfg, tree, mode, prefill_chunk=chunk)
    assert ({r.rid: r.generated for r in sliced.requests}
            == {r.rid: r.generated for r in whole.requests})


def test_numeric_engine_buckets_and_params_resolved_once(weights):
    """Bucketed decode migrates the session's banks and keeps its tokens;
    the engine resolves its parameter tree once and the session reuses it."""
    _, port_cfg, _, tree = weights
    fixed = _port_engine(port_cfg, tree, "npe8", capacity=48)
    eng = NPEEngine(port_cfg, PHW, bits=8, npe=True, params=tree, device="cpu",
                    **{**NUMERIC, "capacity": 48, "seq_buckets": (8, 16)})
    assert isinstance(eng.params, tn.ParamTree) and eng.session.params is eng.params
    _submit(eng, N_REQ, MAX_PROMPT, port_cfg.vocab_size)
    stats = eng.run()
    assert stats.bucket_migrations > 0
    assert _stamps(stats).keys() == _stamps(fixed).keys()
    assert ({r.rid: r.generated for r in stats.requests}
            == {r.rid: r.generated for r in fixed.requests})


# ---------------------------------------------------------------------------
# Observability: the same Chrome trace, byte for byte
# ---------------------------------------------------------------------------

TRACE_KINDS = ("engine", "replicate", "pipeline", "tensor", "prefill_decode")


def _traced_runs(kind):
    ref_cfg, port_cfg = _cfgs(num_layers=4) if kind == "pipeline" else _cfgs()
    docs = []
    for obs, cfg, hw, Engine, Fleet in (
            (robs, ref_cfg, RHW, RefEngine, rfleet.NPEFleet),
            (pobs, port_cfg, PHW, NPEEngine, pfleet.NPEFleet)):
        tr = obs.Tracer(clock_hz=hw.clock_hz)
        kw = dict(slots=2, capacity=24, max_new_tokens=6, tracer=tr)
        if kind == "engine":
            owner = Engine(cfg, hw, **kw)
        else:
            if kind == "prefill_decode":
                kw.update(prefill_chunk=8, prefill_overlays=1)
            owner = Fleet(cfg, hw, overlays=2, shard=kind, **kw)
        _submit(owner, 8, 12, cfg.vocab_size, rate_rps=50.0)
        stats = owner.run()
        docs.append((obs.trace_to_dict(tr, report=stats.report()), stats, tr))
    return docs


@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_trace_byte_identical_valid_and_reconciled(kind):
    (rdoc, rstats, _), (pdoc, pstats, ptr) = _traced_runs(kind)
    assert pobs.dumps_trace(pdoc) == robs.dumps_trace(rdoc)
    assert pobs.validate_trace(pdoc) == []
    an = analyze(pdoc)
    summary = ptr.summary()
    assert an["makespan"] == (pstats.makespan_cycles if kind != "engine"
                              else pstats.total_cycles)
    for o, st in summary["overlays"].items():
        assert an["overlays"][int(o)]["charged"] == st["charged_cycles"]
        assert an["overlays"][int(o)]["units"] == st["unit_busy"]
    assert ({str(rid): r["attributed"] for rid, r in an["requests"].items()}
            == {rid: r["attributed_cycles"] for rid, r in summary["requests"].items()})


def test_profile_cli_renders_a_trace(tmp_path, capsys):
    from repro_torch.npec.obs import profile
    (_, _, _), (pdoc, _, _) = _traced_runs("tensor")
    path = tmp_path / "trace.json"
    path.write_text(pobs.dumps_trace(pdoc))
    assert profile.main([str(path), "--top", "3"]) == 0
    assert "per-overlay unit utilization" in capsys.readouterr().out
    bad = dict(pdoc, traceEvents=[{"ph": "X"}])
    path.write_text(json.dumps(bad))
    assert profile.main([str(path)]) == 1


# ---------------------------------------------------------------------------
# Fleet
# ---------------------------------------------------------------------------

FLEETS = [("replicate", 1, None), ("replicate", 2, 8.0), ("replicate", 4, None),
          ("pipeline", 2, None), ("pipeline", 4, 8.0), ("tensor", 2, None),
          ("tensor", 2, 8.0), ("prefill_decode", 2, 8.0), ("prefill_decode", 3, None)]


def _fleet_pair(shard, n, rate, **extra):
    ref_cfg, port_cfg = _cfgs(num_layers=4)
    out = []
    for Fleet, cfg, hw in ((rfleet.NPEFleet, ref_cfg, RHW),
                           (pfleet.NPEFleet, port_cfg, PHW)):
        f = Fleet(cfg, hw, overlays=n, shard=shard, slots=2, capacity=24,
                  max_new_tokens=6, **extra)
        _submit(f, 10, 12, cfg.vocab_size, rate_rps=rate)
        out.append((f, f.run()))
    return out


@pytest.mark.parametrize("shard,n,rate", FLEETS)
def test_fleet_matches_reference(shard, n, rate):
    (_, ref), (_, port) = _fleet_pair(shard, n, rate)
    assert port.report() == ref.report()
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(ref.snapshot(), sort_keys=True)
    assert _stamps(port) == _stamps(ref)


def test_fleet_of_one_bit_equal_to_lone_engine():
    _, cfg = _cfgs()
    lone = NPEEngine(cfg, PHW, slots=2, capacity=24, max_new_tokens=6)
    _submit(lone, 8, 12, cfg.vocab_size)
    ls = lone.run()
    for shard in ("replicate", "tensor"):
        fleet = pfleet.NPEFleet(cfg, PHW, overlays=1, shard=shard, slots=2,
                                capacity=24, max_new_tokens=6)
        _submit(fleet, 8, 12, cfg.vocab_size)
        fs = fleet.run()
        assert fs.makespan_cycles == ls.total_cycles and fs.transfer_cycles == 0
        assert _stamps(fs) == _stamps(ls)


# the smoke BERT's 2 kv heads carve across at most 2 tensor overlays
@pytest.mark.parametrize("shard,n", [("pipeline", 2), ("pipeline", 4), ("tensor", 2),
                                     ("prefill_decode", 2), ("prefill_decode", 4)])
def test_fleet_conserves_tokens_across_strategies(shard, n):
    _, cfg = _cfgs(num_layers=4)

    def run(shard, n):
        fleet = pfleet.NPEFleet(cfg, PHW, overlays=n, shard=shard, slots=2,
                                capacity=24, max_new_tokens=6, prefill_overlays=1)
        _submit(fleet, 10, 12, cfg.vocab_size, rate_rps=8.0)
        return fleet, fleet.run()

    _, rep = run("replicate", n)
    fleet, got = run(shard, n)
    assert ({r.rid: r.generated for r in got.requests}
            == {r.rid: r.generated for r in rep.requests})
    assert sorted(r.rid for r in got.requests) == list(range(10))
    assert all(r.done for r in got.requests) and got.tokens == rep.tokens
    assert all(len(e.pool) == 0 for e in fleet.engines)


def test_fleet_expert_needs_moe():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="expert parallelism"):
        pfleet.NPEFleet(cfg, PHW, overlays=2, shard="expert")


@pytest.mark.parametrize("n", (2, 4))
def test_partition_plans_cover_the_stream_once(n):
    from repro_torch.npec.fleet.partition import _HEAD_RE, _KV_RE
    _, cfg = _cfgs(num_layers=4)
    compiled = tn.compile_decode(cfg, 24, PHW, bits=16, batch=2)
    # pipeline: every instruction in one stage, transfers only at boundaries
    plan = pfleet.partition_pipeline(compiled, n, rows=2)
    xfer = sum(1 for p in plan.stages for i in p.instrs if i.meta.get("xfer"))
    assert sum(len(p.instrs) for p in plan.stages) - xfer == len(compiled.instrs)
    assert xfer == 2 * (n - 1)
    busy = {}
    for p in plan.stages:
        for i in p.instrs:
            if not i.meta.get("xfer"):
                busy[i.unit] = busy.get(i.unit, 0) + i.cycles
    assert busy == compiled.busy_by_unit()
    # tensor: per-head work on exactly one shard, boundaries itemized (the
    # smoke BERT's 2 kv heads carve across 2 overlays)
    tplan = pfleet.partition_tensor(compiled, 2)

    def heads(instrs):
        return sorted(i.tag for i in instrs if _HEAD_RE.search(i.tag) or _KV_RE.search(i.tag))

    assert sorted(t for p in tplan.shards for t in heads(p.instrs)) == heads(compiled.instrs)
    assert tplan.boundaries == 2 * cfg.num_layers + 1
    rplan = rfleet.partition_tensor(
        rn.compile_decode(_cfgs(num_layers=4)[0], 24, RHW, bits=16, batch=2), 2)
    for a, b in zip(tplan.shards, rplan.shards):
        assert [(i.unit, i.tag, i.cycles) for i in a.instrs] == \
            [(i.unit, i.tag, i.cycles) for i in b.instrs]
    # prefill/decode: KV rows sized from the stream's kv exports
    pre = tn.compile_prefill(cfg, 1, PHW, bits=16)
    dplan = pfleet.partition_prefill_decode(pre, prefill_overlays=1, decode_overlays=n - 1)
    rdplan = rfleet.partition_prefill_decode(
        rn.compile_prefill(_cfgs(num_layers=4)[0], 1, RHW, bits=16),
        prefill_overlays=1, decode_overlays=n - 1)
    assert dplan.kv_rows_per_token == rdplan.kv_rows_per_token > 0


# shard_tile: the column shards reassemble (the reference's hypothesis
# property test_tensor_column_shards_reassemble, here on a fixed grid with
# m >= of), and a zero-column shard raises.
SHARD_CASES = [(seed, rows, kmul, m, n)
               for seed, (rows, kmul) in enumerate([(1, 1), (3, 2), (6, 4)])
               for n in (2, 4) for m in (n, n + 1, 7, 12) if m >= n]


@pytest.mark.parametrize("seed,rows,kmul,m,n", SHARD_CASES)
def test_tensor_column_shards_reassemble(seed, rows, kmul, m, n):
    from repro.npec.lower import shard_tile as ref_shard_tile
    from repro_torch.npec.lower import shard_tile
    rng = np.random.default_rng(seed)
    k = 2 * n * kmul
    x = rng.integers(-8, 8, (rows, k)).astype(np.float64)
    w = rng.integers(-8, 8, (k, m)).astype(np.float64)
    full = x @ w
    for axis in ("m", "k"):
        for i in range(n):
            assert shard_tile(PHW, rows, k, m, 16, idx=i, of=n, axis=axis) == \
                ref_shard_tile(RHW, rows, k, m, 16, idx=i, of=n, axis=axis)
    cols = [shard_tile(PHW, rows, k, m, 16, idx=i, of=n, axis="m")["m"] for i in range(n)]
    assert sum(cols) == m and max(cols) - min(cols) <= 1
    off, parts = 0, []
    for c in cols:
        parts.append(x @ w[:, off:off + c])
        off += c
    assert np.array_equal(np.concatenate(parts, axis=1), full)
    ks = [shard_tile(PHW, rows, k, m, 16, idx=i, of=n, axis="k")["k"] for i in range(n)]
    assert ks == [k // n] * n
    partials = [x[:, i * (k // n):(i + 1) * (k // n)] @ w[i * (k // n):(i + 1) * (k // n), :]
                for i in range(n)]
    assert np.array_equal(sum(partials), full)


@pytest.mark.parametrize("m,n", [(1, 2), (1, 4), (2, 4), (3, 4)])
def test_shard_tile_zero_column_shard_raises(m, n):
    """m < of leaves the last shards without a column: the reference divides
    by zero there (ZeroDivisionError); the port raises a ValueError naming
    m, of and the shard, and still returns the shards that have columns."""
    from repro.npec.lower import shard_tile as ref_shard_tile
    from repro_torch.npec.lower import shard_tile
    for i in range(n):
        if i < m:
            assert shard_tile(PHW, 1, 2 * n, m, 16, idx=i, of=n, axis="m") == \
                ref_shard_tile(RHW, 1, 2 * n, m, 16, idx=i, of=n, axis="m")
            continue
        with pytest.raises(ZeroDivisionError):
            ref_shard_tile(RHW, 1, 2 * n, m, 16, idx=i, of=n, axis="m")
        with pytest.raises(ValueError, match=rf"shard {i} of {n}.*m={m}"):
            shard_tile(PHW, 1, 2 * n, m, 16, idx=i, of=n, axis="m")


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_trace_cli_checks_against_the_hand_built_program(capsys, monkeypatch):
    """`--check` at --seq 64 on the CPU: the hand-built comparison at full
    size (cost only), the executor's check on the smoke configuration."""
    from repro_torch import configs
    from repro_torch.npec import trace
    real_check, real_config = trace._check, configs.get_config

    def smoke_check(args, device):
        with monkeypatch.context() as m:
            m.setattr(configs, "get_config", functools.partial(real_config, smoke=True))
            return real_check(args, device)

    monkeypatch.setattr(trace, "_check", smoke_check)
    assert trace.main(["--model", "bert_base", "--seq", "64", "--check",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "vs hand-built" in out and "(0.00% deviation" in out
    assert "npec check OK" in out


def _fleet_args(shard, overlays, rate):
    return argparse.Namespace(
        arch="bert_base", shard=shard, overlays=overlays, vrwidth=1024, bits=16,
        cycle_model="streaming", capacity=24, gen=6, batch=2, prefill_chunk=None,
        prefill_overlays=1, seq_buckets=None, window=None, rate=rate, requests=6,
        trace=None, json=None, smoke=True)


@pytest.mark.parametrize("shard,overlays,rate", [("replicate", 2, 8.0), ("pipeline", 2, None),
                                                 ("tensor", 2, None),
                                                 ("prefill_decode", 2, None)])
def test_serve_npec_fleet_matches_reference(shard, overlays, rate):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    args = _fleet_args(shard, overlays, rate)
    assert serve.run_npec_fleet(args) == ref_serve.run_npec_fleet(args)


def test_serve_npec_engine_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    trace, rep = tmp_path / "t.json", tmp_path / "r.json"
    serve.main(["--backend", "npec", "--smoke", "--device", "cpu", "--npe", "--bits", "8",
                "--trace", str(trace), "--report", str(rep)])
    out = capsys.readouterr().out
    assert "overlay model (FPGA, 200 MHz), not time on the card" in out
    assert "p50_ms" in out and "[overlay model]" in out and "serve OK" in out
    snap = json.loads(rep.read_text())
    assert snap["report"]["requests"] == 4
    assert pobs.validate_trace(json.loads(trace.read_text())) == []

"""The port's npec compiler and executor for the moe family against the
reference's (`repro.npec`), on the CPU.

  * granite_moe_1b_a400m (an MoE block in every layer; softmax top-2 of 4
    at smoke size) and llama4_maverick_400b_a17b (interleave 2: a dense
    layer, then an MoE one with a sigmoid top-1 router and a shared
    expert): the prefill stream at seq 8 and 16 compiles to the same graph,
    instructions and greedy/streaming cycles, and the port's executor gives
    the reference executor's logits in float, NPE-8 and NPE-16;
  * `trace_moe_block`'s routing intermediates are held bit for bit in
    tests/test_torch_npec_moe_routing.py;
  * the router and expert products stay float32 in NPE-8 (no `quant_matmul`
    launch is expected for them, and the stream's experts give the float
    products' bits); MRU/MWU units appear in the instruction mix;
  * the tracer's `--check` CLI at granite's and llama4's smoke widths on
    the CPU, the model given the executor's expert ids;
  * the full-size MoE super-blocks' cycle rows are rebuilt in
    tests/test_torch_npec_records.py.

Weights come from the reference's `registry.init_params` through
`param_tree_from_jax`; the port runs with device="cpu".  Tolerances: NPE
5e-3 (tests/conftest.py), and past it an NPE-8 case within twice the
reference's own change under a 1-ulp weight nudge, up or down (a routing
choice or an int8 step can flip with an ulp); float within FLOAT_TOL, 5e-6, the
reference's own float noise (tests/test_torch_npec_exec.py).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.overlay import NPEHardware as RefHW  # noqa: E402
from repro.models import registry  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.overlay import NPEHardware as PortHW  # noqa: E402
from repro_torch.models.convert import param_tree_from_jax  # noqa: E402

NPE_TOL = 5e-3
FLOAT_TOL = 5e-6
NUDGE_FACTOR = 2.0
ARCHS = ("granite_moe_1b_a400m", "llama4_maverick_400b_a17b")


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    ref = dataclasses.replace(ref_config(request.param, smoke=True), dtype="float32")
    port = dataclasses.replace(port_config(request.param, smoke=True), dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, registry.init_params(ref, jax.random.PRNGKey(0)))
    return ref, port, params, param_tree_from_jax(params)


def _mode(cfg, mode):
    return {"float": cfg, "npe8": cfg.with_npe(quant_bits=8),
            "npe16": cfg.with_npe(quant_bits=16)}[mode]


def _nudged(params, to=np.inf):
    """The parameters with every weight moved by one float32 ulp towards `to`."""
    return jax.tree_util.tree_map(
        lambda a: np.nextafter(np.asarray(a, np.float32), np.float32(to)), params)


def _err(want, got) -> float:
    return float(np.max(np.abs(np.asarray(want, np.float32) - got.numpy())))


def _rows(compiled):
    g = compiled.graph
    nodes = [(n.id, n.op, tuple(n.inputs), tuple(n.shape), n.dtype, n.attrs, n.tag)
             for n in g.nodes]
    instrs = [(i.unit, i.op, i.cycles, tuple(i.deps), i.tag, tuple(i.shape), i.node, i.meta)
              for i in compiled.instrs]
    return nodes, (g.inputs, g.outputs, g.caches), instrs, compiled.counts_by_unit()


@pytest.mark.parametrize("mode", ("float", "npe8", "npe16"))
@pytest.mark.parametrize("seq", (8, 16))
def test_prefill_compiles_and_executes_as_the_reference(setup, seq, mode):
    ref, port, params, tree = setup
    bits = 8 if mode == "npe8" else 16
    want_c = rn.compile_model(ref, seq, RefHW(), bits=bits)
    got_c = tn.compile_model(port, seq, PortHW(), bits=bits)
    assert _rows(got_c) == _rows(want_c)
    assert tn.greedy_schedule(got_c) == rn.greedy_schedule(want_c)
    assert tn.stream_schedule(got_c) == rn.stream_schedule(want_c)
    tokens = np.random.default_rng(seq).integers(0, ref.vocab_size, (2, seq)).astype(np.int32)
    want = rn.execute(want_c, params, {"tokens": tokens}, cfg=_mode(ref, mode))
    got = tn.execute(got_c, tree, {"tokens": tokens}, cfg=_mode(port, mode), device="cpu")
    assert got.peak_live_bytes == want.peak_live_bytes and got.n_instrs == want.n_instrs
    err = _err(want[0], got[0])
    if mode == "float":
        assert err <= FLOAT_TOL, err
        if seq == 16:   # the reference's own noise, measured again
            with jax.disable_jit():
                model = registry.apply(ref, params, tokens, remat=False)
            assert _err(model, torch.from_numpy(np.array(want[0]))) <= FLOAT_TOL
    elif err > NPE_TOL:
        assert mode == "npe8", err
        noise = max(_err(want[0], torch.from_numpy(np.array(rn.execute(
            want_c, _nudged(params, to), {"tokens": tokens}, cfg=_mode(ref, mode))[0])))
            for to in (np.inf, -np.inf))
        assert err <= NUDGE_FACTOR * noise, (err, noise)


def test_moe_units_in_the_instruction_mix(setup):
    """The dispatch scatter is MWU traffic and the expert gathers and the
    combine MRU traffic, one instruction a node, as the reference counts."""
    ref, port, _, _ = setup
    counts = tn.compile_model(port, 16, PortHW(), bits=8).counts_by_unit()
    assert counts == rn.compile_model(ref, 16, RefHW(), bits=8).counts_by_unit()
    m, moe_layers = port.moe, port.num_layers // port.moe.interleave
    assert counts["MWU"] == moe_layers
    assert counts["MRU"] == moe_layers * (m.num_experts + 1)


def test_router_and_expert_products_stay_float(setup):
    """In NPE-8 the MMU takes the attention, dense-MLP, shared-expert and
    head weights; the router and expert products are float32 products, so
    `expected_launches` counts no `quant_matmul` for them, and one MoE
    block's routing and (without a shared expert, which the MMU takes)
    its output in NPE-8 equal the block's with the MMU off bit for bit."""
    _, port, _, tree = setup
    g = tn.compile_model(port, 16, PortHW(), bits=8).graph
    weight_mm = [n for n in g.nodes if n.op == "matmul" and g.node(n.inputs[1]).op == "param"]
    pinned = [n for n in weight_mm if n.attrs.get("quantize") is False]
    assert pinned and all(".router" in n.tag or ".x" in n.tag for n in pinned)
    counts = tn.expected_launches(g, npe_quant=True, bits=8, use_pwl=True)
    assert counts["quant_matmul"] == len(weight_mm) - len(pinned)
    block = tn.trace_moe_block(port, 16, layer=0, debug_outputs=True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, port.d_model)).astype(np.float32))
    pwl = dataclasses.replace(port.with_npe(quant_bits=8), npe_quant=False)
    a = tn.execute(block, tree, {"x": x}, cfg=port.with_npe(quant_bits=8), device="cpu")
    b = tn.execute(block, tree, {"x": x}, cfg=pwl, device="cpu")
    same = [torch.equal(p, q) for p, q in zip(a.outputs, b.outputs)]
    assert all(same[1:]) and (same[0] or port.moe.shared_expert)
    shared = 3 if port.moe.shared_expert else 0
    assert tn.expected_launches(block, npe_quant=True, bits=8,
                                use_pwl=True)["quant_matmul"] == shared


@pytest.mark.parametrize("arch", ARCHS)
def test_check_cli_at_smoke_widths(arch, capsys, monkeypatch):
    """`python -m repro_torch.npec.trace --model <moe> --check` at the smoke
    widths on the CPU: the executor against models/transformer.apply in
    every mode, the model taking the executor's expert ids at each MoE
    layer (`models/moe.ForcedRouting`)."""
    from repro_torch import configs
    from repro_torch.npec import trace
    monkeypatch.setattr(configs, "get_config", functools.partial(configs.get_config, smoke=True))
    assert trace.main(["--model", arch, "--check", "--device", "cpu", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("the model's own top-k differs") == 3
    assert out.rstrip().endswith("npec check OK")

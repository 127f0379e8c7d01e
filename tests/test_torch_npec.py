"""The port's npec compiler against the reference's, on the CPU.

The same configuration goes through `repro.npec` and `repro_torch.npec`:
each case must give the same graph (op, inputs, shape, dtype, attrs and tag,
node for node, and the same inputs, outputs, caches, cache updates and kv
exports), the same lowered instructions, `counts_by_unit`, `busy_by_unit`
and `mmu_tiling_summary`, and the same greedy and streaming schedules
(totals and stalls), exactly.  The cycles are the FPGA overlay model's.
"""
import dataclasses

import pytest

import repro.npec as rn
import repro_torch.npec as tn
from repro.configs import get_config as ref_config
from repro.core.overlay import NPEHardware as RefHW
from repro_torch.configs import get_config as port_config
from repro_torch.core.overlay import NPEHardware as PortHW

# stream -> (compile function name, positional size, keyword arguments)
STREAMS = {
    "encoder128": ("compile_model", 128, {}),
    "decode256": ("compile_decode", 256, {}),
    "decode256x8": ("compile_decode", 256, {"batch": 8}),
    "prefill96": ("compile_prefill", 96, {}),
    "chunk32of256": ("compile_prefill", 32, {"cache_len": 256}),
}


def _configs(layers):
    ref, port = ref_config("bert_base"), port_config("bert_base")
    if layers is not None:
        ref = dataclasses.replace(ref, num_layers=layers)
        port = dataclasses.replace(port, num_layers=layers)
    return ref, port


def _graph_rows(graph):
    nodes = [(n.id, n.op, tuple(n.inputs), tuple(n.shape), n.dtype, n.attrs, n.tag)
             for n in graph.nodes]
    return nodes, (graph.inputs, graph.outputs, graph.caches, graph.cache_updates,
                   graph.kv_exports)


def _instr_rows(compiled):
    return [(i.unit, i.op, i.cycles, tuple(i.deps), i.tag, tuple(i.shape), i.node, i.meta)
            for i in compiled.instrs]


@pytest.mark.parametrize("vrwidth", [512, 1024])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("layers", [2, None], ids=["2layers", "full"])
def test_compiles_as_the_reference(layers, stream, bits, vrwidth):
    fn, size, kw = STREAMS[stream]
    ref_cfg, port_cfg = _configs(layers)
    want = getattr(rn, fn)(ref_cfg, size, RefHW(vrwidth=vrwidth), bits=bits, **kw)
    got = getattr(tn, fn)(port_cfg, size, PortHW(vrwidth=vrwidth), bits=bits, **kw)
    assert _graph_rows(got.graph) == _graph_rows(want.graph)
    assert _instr_rows(got) == _instr_rows(want)
    assert got.counts_by_unit() == want.counts_by_unit()
    assert got.busy_by_unit() == want.busy_by_unit()
    assert got.mmu_tiling_summary() == want.mmu_tiling_summary()
    assert tn.greedy_schedule(got) == rn.greedy_schedule(want)
    assert tn.stream_schedule(got) == rn.stream_schedule(want)
    assert tn.transfer_cycles(got) == rn.transfer_cycles(want)


@dataclasses.dataclass(frozen=True)
class Shape:
    """The attributes the dims-only tracers read (the reference's BertShape)."""
    seq: int = 128
    hidden: int = 768
    heads: int = 12
    head_dim: int = 64
    d_ff: int = 3072


@pytest.mark.parametrize("kind", ["encoder", "decode", "decode_x4_ring", "slice"])
def test_dims_only_streams_as_the_reference(kind):
    from repro.core.cycles import BertShape
    ref_shape = BertShape(seq=128, hidden=768, heads=12, d_ff=3072)
    port_shape = Shape()
    assert port_shape.head_dim == ref_shape.head_dim
    calls = {
        "encoder": lambda m, hw, s: m.compile_bert_shape(hw, s, 8, layers=2),
        "decode": lambda m, hw, s: m.compile_decode_bert_shape(hw, s, 256, 8, layers=2),
        "decode_x4_ring": lambda m, hw, s: m.compile_decode_bert_shape(
            hw, s, 64, 16, layers=1, batch=4, window=True),
        "slice": lambda m, hw, s: m.compile_prefill_slice_shape(hw, s, 256, 32, 8, layers=2),
    }
    want = calls[kind](rn, RefHW(), ref_shape)
    got = calls[kind](tn, PortHW(), port_shape)
    assert _graph_rows(got.graph) == _graph_rows(want.graph)
    assert _instr_rows(got) == _instr_rows(want)
    assert tn.greedy_schedule(got) == rn.greedy_schedule(want)
    assert tn.stream_schedule(got) == rn.stream_schedule(want)


def test_issue_order_and_schedule_for_as_the_reference():
    ref_cfg, port_cfg = _configs(2)
    want = rn.compile_decode(ref_cfg, 64, RefHW(), bits=8, batch=2)
    got = tn.compile_decode(port_cfg, 64, PortHW(), bits=8, batch=2)
    for model in ("dag", "streaming"):
        assert tn.schedule_for(got, model) == rn.schedule_for(want, model)
    a, b = tn.issue_order(got), rn.issue_order(want)
    assert [(i.unit, i.op, i.cycles, i.deps, i.tag) for i in a.instrs] == \
        [(i.unit, i.op, i.cycles, i.deps, i.tag) for i in b.instrs]
    t_port = tn.make_transfer("MWU", 288, (3,), tag="x")
    t_ref = rn.make_transfer("MWU", 288, (3,), tag="x")
    assert dataclasses.asdict(t_port) == dataclasses.asdict(t_ref)


def test_other_families_raise_compile_error():
    """The reference's feature gates: a config the reference cannot compile
    raises `CompileError` in the port with the reference's message, for
    every entry point (gemma3's local:global attention and qk-norm,
    command-r's parallel block, qwen2-vl's family, a BERT-shaped config
    with learned positions traced as a decoder, and MoE decode/serving)."""
    bert_as_dense = lambda get: dataclasses.replace(get("bert_base"), family="dense",  # noqa: E731
                                                    name="dense_x")
    cases = [lambda get: get("gemma3_27b", smoke=True),
             lambda get: get("command_r_plus_104b", smoke=True),
             lambda get: get("qwen2_vl_7b", smoke=True), bert_as_dense]
    moe = lambda get: get("granite_moe_1b_a400m", smoke=True)  # noqa: E731
    calls = [(case, fn) for case in cases
             for fn in ("compile_model", "compile_decode", "compile_prefill")]
    calls += [(moe, "compile_decode"), (moe, "compile_prefill")]
    for case, fn in calls:
        msgs = []
        for pkg, get, hw in ((rn, ref_config, RefHW), (tn, port_config, PortHW)):
            with pytest.raises(pkg.CompileError) as err:
                getattr(pkg, fn)(case(get), 16, hw())
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

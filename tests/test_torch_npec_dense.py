"""The port's npec compiler and executor for the dense family against the
reference's (`repro.npec`), on the CPU.

  * glm4_9b (smoke: 2 layers, width 128, 4 query heads over 2 kv heads, qkv
    bias, RMSNorm, RoPE, SwiGLU, untied head): the prefill stream at seq 8
    and 16 compiles to the same graph, instructions and greedy/streaming
    cycles, and the port's executor gives the reference executor's logits
    in float, NPE-8 and NPE-16; the seq-16 float case measures the
    reference's own noise (its executor against its model) again and holds
    it to FLOAT_TOL;
  * the decode (batch 1 and 2), chunked-prefill and windowed streams, at
    smoke size and at GLM4-9B's and StarCoder2-3B's full size (one layer),
    compile to the same graphs, instructions and cycles;
  * the reference's feature gates: gemma3 (local:global, qk-norm),
    command-r (parallel block), qwen2-vl and MoE decode raise the same
    `CompileError`;
  * `param_tree_from_model` of the port's decoders equals
    `param_tree_from_jax` of the same weights;
  * the tracer's `--check` CLI at glm4's smoke widths on the CPU.
Executed decode, chunked and ring streams are held in
tests/test_torch_npec_dense_decode.py, the serving engine in
tests/test_torch_npec_dense_engine.py; weights and tolerances are
tests/_torch_npec_dense_common.py's.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from _torch_npec_dense_common import (FLOAT_TOL, MODES, bits_of, gate,  # noqa: E402,F401
                                      glm4, highest_precision, load, max_err, mode_cfg,
                                      same_program, draw_tokens)
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.overlay import NPEHardware as RefHW  # noqa: E402
from repro.models import registry  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.overlay import NPEHardware as PortHW  # noqa: E402
from repro_torch.models import registry as port_registry  # noqa: E402
from repro_torch.models.convert import param_tree_from_model, params_from_jax  # noqa: E402


# ---------------------------------------------------------------------------
# Compiles as the reference
# ---------------------------------------------------------------------------

STREAMS = {
    "decode16": ("glm4_9b", "compile_decode", 16, {}),
    "decode16x2": ("glm4_9b", "compile_decode", 16, {"batch": 2}),
    "chunk8of32": ("glm4_9b", "compile_prefill", 8, {"cache_len": 32}),
    "prefill24": ("glm4_9b", "compile_prefill", 24, {}),
    "ring_window": ("starcoder2_3b", "compile_decode", None, {"window": True, "batch": 2}),
    "ring_prefill": ("starcoder2_3b", "compile_prefill", 16, {"window": True}),
}


@pytest.mark.parametrize("bits", (8, 16))
@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("size", ("smoke", "full"))
def test_streams_compile_as_the_reference(size, stream, bits):
    arch, fn, n, kw = STREAMS[stream]
    ref, port = ref_config(arch, smoke=size == "smoke"), port_config(arch, smoke=size == "smoke")
    n = n if n is not None else ref.window
    layers = None if size == "smoke" else 1
    want = getattr(rn, fn)(ref, n, RefHW(), bits=bits, layers=layers, **kw)
    got = getattr(tn, fn)(port, n, PortHW(), bits=bits, layers=layers, **kw)
    same_program(want, got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seq", (8, 16))
def test_prefill_compiles_and_executes_as_the_reference(glm4, seq, mode):
    ref, port, params, tree = glm4
    want_c = rn.compile_model(ref, seq, RefHW(), bits=bits_of(mode))
    got_c = tn.compile_model(port, seq, PortHW(), bits=bits_of(mode))
    same_program(want_c, got_c)
    tokens = draw_tokens((2, seq), ref.vocab_size, seed=seq)
    run_ref = lambda p: [rn.execute(want_c, p, {"tokens": tokens},  # noqa: E731
                                    cfg=mode_cfg(ref, mode))[0]]
    want = rn.execute(want_c, params, {"tokens": tokens}, cfg=mode_cfg(ref, mode))
    got = tn.execute(got_c, tree, {"tokens": tokens}, cfg=mode_cfg(port, mode), device="cpu")
    assert got.peak_live_bytes == want.peak_live_bytes and got.n_instrs == want.n_instrs
    gate(mode, max_err([want[0]], [got[0]]), [want[0]], run_ref, params)
    if mode == "float" and seq == 16:
        with jax.disable_jit():
            model = registry.apply(ref, params, jnp.asarray(tokens), remat=False)
        assert max_err([model], [torch.from_numpy(np.asarray(want[0]))]) <= FLOAT_TOL


# ---------------------------------------------------------------------------
# Gates, weights, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,fn", [(a, f) for a in ("gemma3_27b", "command_r_plus_104b",
                                                      "qwen2_vl_7b")
                                     for f in ("compile_model", "compile_decode",
                                               "compile_prefill")]
                         + [("granite_moe_1b_a400m", "compile_decode"),
                            ("granite_moe_1b_a400m", "compile_prefill"),
                            ("llama4_maverick_400b_a17b", "compile_decode")])
def test_feature_gates_raise_as_the_reference(arch, fn):
    msgs = []
    for pkg, get, hw in ((rn, ref_config, RefHW), (tn, port_config, PortHW)):
        with pytest.raises(pkg.CompileError) as err:
            getattr(pkg, fn)(get(arch, smoke=True), 16, hw())
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("arch", ("glm4_9b", "starcoder2_3b", "granite_moe_1b_a400m",
                                  "llama4_maverick_400b_a17b"))
def test_param_tree_from_model_is_the_reference_tree(arch):
    ref, port, params, tree = load(arch)
    model = port_registry.build_model(port, device="cpu")
    model.load_state_dict(params_from_jax(params, port))
    got = param_tree_from_model(model)

    def walk(a, b, path=()):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                assert b[k].dtype == torch.float32 and torch.equal(a[k], b[k]), path + (k,)
    walk(tree, got)


def test_check_cli_at_smoke_widths(capsys, monkeypatch):
    """`python -m repro_torch.npec.trace --model glm4_9b --check` at the
    smoke widths on the CPU: the executor against models/transformer.apply
    in every mode and the decode rollout against the serving prefill."""
    from repro_torch import configs
    from repro_torch.npec import trace
    monkeypatch.setattr(configs, "get_config", functools.partial(configs.get_config, smoke=True))
    assert trace.main(["--model", "glm4_9b", "--check", "--device", "cpu", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("executor vs models/transformer.apply") == 3
    assert "decode stream (8 steps)" in out and out.rstrip().endswith("npec check OK")

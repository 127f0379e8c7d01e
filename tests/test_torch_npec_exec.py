"""The port's npec executor against the reference's, on the CPU.

The smoke BERT (2 layers, width 128, GQA 4q/2kv) in float32, weights from
the reference's `registry.init_params` through `param_tree_from_jax`; the
same feeds go to `repro.npec.execute` / `DecodeSession` and to the port's
with device="cpu", where the kernel wrappers run their plain versions.

Tolerances (`_gate`):
  * NPE mode: 5e-3 (tests/conftest.py NPE_TOL, the reference's own gate for
    its executor).  At 8 bits one float rounding that differs in the last
    place can move an activation across an int8 step (the two packages sum
    f32 products and LayerNorm statistics in different orders), so past
    5e-3 an NPE-8 case is held to twice the reference's own change under a
    1-ulp weight nudge on the same inputs, the repo's rule for NPE-8
    (ROADMAP, "Done").  The batched NPE-8 scenario needs it: at its second
    step one activation of slot 1 lands on the other side of an int8 step,
    5.47e-3 on these seeds, and the reference's own 1-ulp nudge moves the
    same output by 5.47e-3 (measured on the CPU).
  * Float mode: the reference's own float noise on the same inputs.  Its
    1e-6 float gates already fail on this JAX build (ROADMAP, Faults): its
    executor differs from its own jnp encoder by 1.4e-6 on the encoder case
    below and from its own `decode_step` by 4.8e-7 on the decode case
    (measured on the CPU with these seeds).  FLOAT_TOL is 5e-6, about four
    times the larger; each float test measures the reference's noise again
    and fails if it grows past FLOAT_TOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

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
MODES = ("float", "npe8", "npe16")


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def setup():
    ref = dataclasses.replace(ref_config("bert_base", smoke=True), dtype="float32")
    port = dataclasses.replace(port_config("bert_base", smoke=True), dtype="float32")
    params = registry.init_params(ref, jax.random.PRNGKey(0))
    tree = param_tree_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return ref, port, params, tree


def _mode(cfg, mode):
    return {"float": cfg, "npe8": cfg.with_npe(quant_bits=8),
            "npe16": cfg.with_npe(quant_bits=16)}[mode]


def _bits(mode):
    return 8 if mode == "npe8" else 16


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - (b.numpy() if torch.is_tensor(b) else np.asarray(b)))))


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _nudged(params):
    """The parameters with every weight moved up by one ulp."""
    return jax.tree_util.tree_map(
        lambda a: np.nextafter(np.asarray(a, np.float32), np.float32(np.inf)), params)


def _flat(outs):
    """A scenario's results as one list of arrays."""
    out = []
    for o in outs:
        if isinstance(o, dict):
            out.extend(o[k] for k in sorted(o))
        elif isinstance(o, (list, tuple)):
            out.extend(_flat(o))
        else:
            out.append(o)
    return out


def _max_err(want, got) -> float:
    a, b = _flat(want), _flat(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(np.shape(x)) == tuple(y.shape)
    return max(_err(x, y) for x, y in zip(a, b))


def _gate(mode, err, ref_outputs, run_ref_nudged):
    """err within the mode's tolerance (see the module docstring); the
    nudged reference runs only for an NPE-8 case past 5e-3."""
    if mode == "float":
        assert err <= FLOAT_TOL, err
    elif err > NPE_TOL:
        assert mode == "npe8", err
        noise = _max_err(ref_outputs, [torch.from_numpy(np.array(x, np.float32))
                                       for x in _flat(run_ref_nudged())])
        assert err <= NUDGE_FACTOR * noise, (err, noise)


def _encoder_scenario(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """One execute of the encoder stream on 2 x 32 tokens."""
    return pkg.execute(pkg.compile_model(cfg, 32, hw, bits=bits), weights,
                       {"tokens": _tokens((2, 32), cfg.vocab_size)}, cfg=mcfg, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_encoder_execute(setup, mode):
    ref, port, params, tree = setup
    rc, pc = _mode(ref, mode), _mode(port, mode)
    run_ref = lambda p: [_encoder_scenario(rn, RefHW(), ref, rc, p, _bits(mode))[0]]
    want = _encoder_scenario(rn, RefHW(), ref, rc, params, _bits(mode))
    got = _encoder_scenario(tn, PortHW(), port, pc, tree, _bits(mode), device="cpu")
    assert got[0].dtype == torch.float32
    assert got.peak_live_bytes == want.peak_live_bytes
    assert got.n_instrs == want.n_instrs
    _gate(mode, _max_err([want[0]], [got[0]]), [want[0]], lambda: run_ref(_nudged(params)))
    if mode == "float":
        from repro.models import bert as bert_mod
        from repro.models import common as cm
        tokens = _tokens((2, 32), ref.vocab_size)
        noise = _err(bert_mod.encode(rc, cm.cast_tree(params, "float32"), tokens), want[0])
        assert noise <= FLOAT_TOL


def test_execute_reuses_a_prepared_tree(setup):
    """A `ParamTree` resolves each slice once and gives the same results."""
    ref, port, params, tree = setup
    pc = port.with_npe(quant_bits=8)
    compiled = tn.compile_model(port, 16, PortHW(), bits=8)
    tokens = _tokens((16,), port.vocab_size, seed=5)
    prepared = tn.ParamTree(tree, "cpu")
    a = tn.execute(compiled, prepared, {"tokens": tokens}, cfg=pc, device="cpu")[0]
    n = len(prepared._memo)
    b = tn.execute(compiled, prepared, {"tokens": tokens}, cfg=pc, device="cpu")[0]
    assert len(prepared._memo) == n > 0
    assert torch.equal(a, b)
    assert torch.equal(a, tn.execute(compiled, tree, {"tokens": tokens}, cfg=pc,
                                     device="cpu")[0])


STEPS = 6


def _decode_scenario(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """STEPS steps of the per-sequence stream (a feed batch of 2) over a
    16-row cache: every step's output and the final banks."""
    sess = pkg.DecodeSession(pkg.compile_decode(cfg, 16, hw, bits=bits), weights,
                             batch=2, cfg=mcfg, **kw)
    tokens = _tokens((2, STEPS), cfg.vocab_size, seed=2)
    outs = [sess.step(tokens[:, t:t + 1]) for t in range(STEPS)]
    assert int(sess.pos) == STEPS
    return outs, dict(sess.caches)


@pytest.mark.parametrize("mode", MODES)
def test_per_sequence_decode_rollout(setup, mode):
    ref, port, params, tree = setup
    rc, pc = _mode(ref, mode), _mode(port, mode)
    run_ref = lambda p: _decode_scenario(rn, RefHW(), ref, rc, p, _bits(mode))
    want = run_ref(params)
    got = _decode_scenario(tn, PortHW(), port, pc, tree, _bits(mode), device="cpu")
    _gate(mode, _max_err(want, got), want, lambda: run_ref(_nudged(params)))
    if mode == "float":
        L, KV, hd = ref.num_layers, ref.num_kv_heads, ref.head_dim
        cache = {"full": {k: jnp.zeros((L, 2, 16, KV, hd), jnp.float32) for k in "kv"}}
        tokens = _tokens((2, STEPS), ref.vocab_size, seed=2)
        with jax.disable_jit():
            for t in range(STEPS):
                step, cache = registry.decode_step(rc, params, cache, tokens[:, t:t + 1],
                                                   jnp.int32(t))
                assert _err(step, np.asarray(want[0][t])) <= FLOAT_TOL


def _batched_scenario(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """A 4-slot stream: slots seeded by `load_slot` from executed prefills
    of ragged prompts, steps with an `active` mask, a slot recycled by
    `reset_slot` and loaded again, then `migrate` from 16 to 32 rows and
    more steps.  Returns every prefill's and step's output, the final
    banks, positions and the rows `migrate` moved."""
    prompts = [_tokens((n,), cfg.vocab_size, seed=10 + n) for n in (5, 9, 3, 7, 6)]
    sess = pkg.DecodeSession(pkg.compile_decode(cfg, 16, hw, bits=bits, batch=4), weights,
                             cfg=mcfg, **kw)
    outs = []

    def load(slot, prompt):
        res = pkg.execute(pkg.compile_prefill(cfg, len(prompt), hw, bits=bits), weights,
                          {"tokens": prompt}, cfg=mcfg, **kw)
        outs.append(res[0])
        sess.load_slot(slot, res.kv_exports, len(prompt))

    def steps(n, active=None, seed=0):
        toks = _tokens((n, 4), cfg.vocab_size, seed=20 + seed)
        outs.extend(sess.step(toks[i], active=active) for i in range(n))

    for slot in range(4):
        load(slot, prompts[slot])
    steps(2)
    steps(2, active=[True, True, False, True], seed=1)
    sess.reset_slot(2)
    load(2, prompts[4])
    steps(1, seed=2)
    moved = sess.migrate(pkg.compile_decode(cfg, 32, hw, bits=bits, batch=4))
    steps(3, seed=3)
    return outs, dict(sess.caches), np.asarray(sess.pos).tolist(), moved, sess.capacity


@pytest.mark.parametrize("mode", MODES)
def test_batched_slots_load_reset_migrate(setup, mode):
    """The 4-slot scenario (`_batched_scenario`) in both packages: every
    output, bank, position and the rows moved by `migrate`."""
    ref, port, params, tree = setup
    rc, pc = _mode(ref, mode), _mode(port, mode)
    run_ref = lambda p: _batched_scenario(rn, RefHW(), ref, rc, p, _bits(mode))
    want = run_ref(params)
    got = _batched_scenario(tn, PortHW(), port, pc, tree, _bits(mode), device="cpu")
    assert got[2:] == want[2:] and got[3] > 0 and got[4] == 32
    _gate(mode, _max_err(want[:2], got[:2]), want[:2],
          lambda: run_ref(_nudged(params))[:2])


def test_batched_slot_lifecycle_errors(setup):
    _, port, _, tree = setup
    ps = tn.DecodeSession(tn.compile_decode(port, 8, PortHW(), batch=2), tree, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        ps.reset_slot(2)
    with pytest.raises(ValueError, match="exceeds the compiled cache"):
        ps.load_slot(0, {}, 9)
    ps.pos[:] = 8
    with pytest.raises(ValueError, match="exhausted"):
        ps.step(np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="cannot migrate"):
        ps.migrate(tn.compile_decode(port, 4, PortHW(), batch=2))
    single = tn.DecodeSession(tn.compile_decode(port, 8, PortHW()), tree, device="cpu")
    with pytest.raises(ValueError, match="batched-slot"):
        single.reset_slot(0)


def _chunk_scenario(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """Two 4-row slices over 16-row cache banks, carrying the cache updates
    from one to the next: both slices' logits and the final banks."""
    compiled = pkg.compile_prefill(cfg, 4, hw, bits=bits, cache_len=16)
    prompt = _tokens((8,), cfg.vocab_size, seed=7)
    caches = {name: np.zeros(compiled.graph.node(nid).shape, np.float32)
              for name, nid in compiled.graph.caches.items()}
    outs = []
    for c in range(2):
        rows = np.arange(4 * c, 4 * c + 4, dtype=np.int32)
        res = pkg.execute(compiled, weights, dict(caches, tokens=prompt[rows], pos_ids=rows),
                          cfg=mcfg, **kw)
        outs.append(res[0])
        caches.update(res.cache_updates)
    return outs, caches


@pytest.mark.parametrize("mode", MODES)
def test_chunked_prefill_slices(setup, mode):
    ref, port, params, tree = setup
    rc, pc = _mode(ref, mode), _mode(port, mode)
    run_ref = lambda p: _chunk_scenario(rn, RefHW(), ref, rc, p, _bits(mode))
    want = run_ref(params)
    got = _chunk_scenario(tn, PortHW(), port, pc, tree, _bits(mode), device="cpu")
    for bank in got[1].values():
        assert not bank[8:].any()              # rows past the prompt stay empty
    _gate(mode, _max_err(want, got), want, lambda: run_ref(_nudged(params)))


def test_other_ops_raise(setup):
    """An op the executor has no rule for raises; the IR's ops all have one
    (rope, rmsnorm, mul, topk, scatter_slot and gather since the dense and
    MoE families)."""
    _, port, _, tree = setup
    from repro_torch.npec.ir import GraphBuilder
    b = GraphBuilder()
    x = b.input("x", (4, 8))
    y = b.act(x, "gelu", tag="f")
    b.output(y)
    b.g.node(y).op = "fft"
    with pytest.raises(NotImplementedError, match="no rule for 'fft'"):
        tn.execute(b.g, tree, {"x": np.zeros((4, 8), np.float32)}, device="cpu")
    r = GraphBuilder()
    x = r.input("x", (4, 8))
    r.output(r.rope(x, theta=10000.0, tag="r"))
    got = tn.execute(r.g, tree, {"x": np.ones((4, 8), np.float32)}, device="cpu")[0]
    want = rn.execute(r.g, {}, {"x": np.ones((4, 8), np.float32)})[0]
    assert _err(want, got) <= FLOAT_TOL


def test_launch_counts_from_the_graph(setup):
    """`expected_launches` counts one kernel a node: 39 weight matmuls a
    layer of the smoke encoder (4 q + 2 k + 2 v heads, out, two FFN), and
    each softmax, layernorm and act node in PWL mode."""
    _, port, _, _ = setup
    g = tn.compile_model(port, 32, PortHW(), bits=8).graph
    heads, kv = port.num_heads, port.num_kv_heads
    per_layer = heads + 2 * kv + 3
    assert tn.expected_launches(g, npe_quant=True, bits=8, use_pwl=True) == {
        "quant_matmul": per_layer * port.num_layers, "nvu_softmax": heads * port.num_layers,
        "nvu_layernorm": 1 + 2 * port.num_layers, "pwl_eval": port.num_layers,
        "flash_attention": 0}
    assert tn.expected_launches(g, npe_quant=True, bits=16, use_pwl=True)["quant_matmul"] == 0
    assert set(tn.expected_launches(g, npe_quant=False, bits=8, use_pwl=False).values()) == {0}

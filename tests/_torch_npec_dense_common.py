"""What the dense-family npec parity tests share (tests/test_torch_npec_dense.py,
test_torch_npec_dense_decode.py and test_torch_npec_dense_engine.py): the
smoke configs and the reference's weights, the modes, the tolerances and the
comparisons.

Weights come from the reference's `registry.init_params` through
`param_tree_from_jax`.  Tolerances: NPE 5e-3 (tests/conftest.py), and past
it an NPE-8 case within twice the reference's own change under a 1-ulp
weight nudge, up or down (`gate`).  Float: FLOAT_TOL, 1e-5, about three
times the reference's own float noise: its executor differs from its own
model run op by op by 3.0e-6 on the seq-16 glm4 prefill (its 1e-6 gates
already fail on glm4, ROADMAP, Faults), and the port's float cases differ
from the reference's executor by at most 4.5e-6 (measured on the CPU with
these seeds).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.npec as rn
import repro_torch.npec as tn
from repro.configs import get_config as ref_config
from repro.models import registry
from repro_torch.configs import get_config as port_config
from repro_torch.models.convert import param_tree_from_jax

NPE_TOL = 5e-3
FLOAT_TOL = 1e-5
NUDGE_FACTOR = 2.0
MODES = ("float", "npe8", "npe16")


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def load(arch, **over):
    ref = dataclasses.replace(ref_config(arch, smoke=True), dtype="float32", **over)
    port = dataclasses.replace(port_config(arch, smoke=True), dtype="float32", **over)
    params = jax.tree_util.tree_map(np.asarray, registry.init_params(ref, jax.random.PRNGKey(0)))
    return ref, port, params, param_tree_from_jax(params)


@pytest.fixture(scope="module")
def glm4():
    return load("glm4_9b")


def mode_cfg(cfg, mode):
    return {"float": cfg, "npe8": cfg.with_npe(quant_bits=8),
            "npe16": cfg.with_npe(quant_bits=16)}[mode]


def bits_of(mode):
    return 8 if mode == "npe8" else 16


def draw_tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def nudged(params, to=np.inf):
    """The parameters with every weight moved by one float32 ulp towards `to`."""
    return jax.tree_util.tree_map(
        lambda a: np.nextafter(np.asarray(a, np.float32), np.float32(to)), params)


def flat(outs):
    out = []
    for o in outs:
        if isinstance(o, dict):
            out.extend(o[k] for k in sorted(o))
        elif isinstance(o, (list, tuple)):
            out.extend(flat(o))
        else:
            out.append(o)
    return out


def max_err(want, got) -> float:
    a, b = flat(want), flat(got)
    assert len(a) == len(b)
    err = 0.0
    for x, y in zip(a, b):
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert np.shape(x) == y.shape
        err = max(err, float(np.max(np.abs(np.asarray(x, np.float32) - y))))
    return err


def gate(mode, err, want, run_ref, params):
    """err within the mode's tolerance; past NPE_TOL an NPE-8 case is held to
    twice the reference's own change when every weight moves by one ulp up,
    or down (an int8 step the port's last-bit difference crosses is often
    crossed by one of the two)."""
    if mode == "float":
        assert err <= FLOAT_TOL, err
    elif err > NPE_TOL:
        assert mode == "npe8", err
        noise = max(max_err(want, run_ref(nudged(params, to))) for to in (np.inf, -np.inf))
        assert err <= NUDGE_FACTOR * noise, (err, noise)


def program_rows(compiled):
    g = compiled.graph
    nodes = [(n.id, n.op, tuple(n.inputs), tuple(n.shape), n.dtype, n.attrs, n.tag)
             for n in g.nodes]
    instrs = [(i.unit, i.op, i.cycles, tuple(i.deps), i.tag, tuple(i.shape), i.node, i.meta)
              for i in compiled.instrs]
    return (nodes, (g.inputs, g.outputs, g.caches, g.cache_updates, g.kv_exports), instrs,
            compiled.counts_by_unit(), compiled.mmu_tiling_summary())


def same_program(want, got):
    assert program_rows(got) == program_rows(want)
    assert tn.greedy_schedule(got) == rn.greedy_schedule(want)
    assert tn.stream_schedule(got) == rn.stream_schedule(want)

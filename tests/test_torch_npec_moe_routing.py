"""`trace_moe_block`'s routing intermediates in the port's executor against
the reference's (`repro.npec`), on the CPU, over a sweep of E, k, S, the
capacity factor and softmax/sigmoid routers, float and PWL, and over
hypothesis draws: the expert ids and the dispatch buffer bit for bit, a PWL
sigmoid router's gates bit for bit and the others' within four float32 ulps
(torch's exp and sigmoid are other implementations than XLA's, and a
softmax sums E exponentials in another order); the block's output within
FLOAT_TOL, 5e-6, the reference's own float noise
(tests/test_torch_npec_exec.py).  The inputs and router weights lie on a
1/8 grid so that the router product is exact in any order of addition.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.config import MoEConfig as RefMoEConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.convert import param_tree_from_jax  # noqa: E402

FLOAT_TOL = 5e-6
GATE_RTOL = 2.0 ** -21       # four float32 ulps: softmax gates (see _check_block)


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _err(want, got) -> float:
    return float(np.max(np.abs(np.asarray(want, np.float32) - got.numpy())))


def _block_cfgs(E, k, cf, act, npe, D=16, F=8):
    out = []
    for get, moe_cls in ((ref_config, RefMoEConfig), (port_config, MoEConfig)):
        c = dataclasses.replace(get("granite_moe_1b_a400m", smoke=True), dtype="float32",
                                num_layers=1, d_model=D, d_ff=F,
                                moe=moe_cls(num_experts=E, top_k=k, capacity_factor=cf,
                                            router_act=act))
        out.append(c.with_npe(quant_bits=8) if npe else c)
    return out


def _block_params(rng, E, D, F):
    """One MoE layer's weights; the router on a 1/8 grid, so that with x on
    the same grid every router logit is exact whatever the order of sums."""
    g = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)  # noqa: E731
    router = (np.round(rng.standard_normal((1, D, E)) * 2) / 8).astype(np.float32)
    return {"blocks": {"moe": {"router": router, "wg": g(1, E, D, F), "wu": g(1, E, D, F),
                               "wd": g(1, E, F, D)}}}


def _check_block(E, k, S, cf, act, npe, seed):
    rcfg, pcfg = _block_cfgs(E, k, cf, act, npe)
    rng = np.random.default_rng(seed)
    params = _block_params(rng, E, 16, 8)
    x = (np.round(rng.standard_normal((2, S, 16)) * 4) / 8).astype(np.float32)
    want_g = rn.trace_moe_block(rcfg, S, debug_outputs=True)
    got_g = tn.trace_moe_block(pcfg, S, debug_outputs=True)
    assert [(n.op, n.attrs, n.tag) for n in got_g.nodes] == \
        [(n.op, n.attrs, n.tag) for n in want_g.nodes]
    want = rn.execute(want_g, params, {"x": x}, cfg=rcfg)
    got = tn.execute(got_g, param_tree_from_jax(params), {"x": x}, cfg=pcfg, device="cpu")
    _, gates, ids, dispatch = got.outputs
    assert ids.dtype == torch.int32
    assert np.array_equal(np.asarray(want[2]), ids.numpy())
    assert np.array_equal(np.asarray(want[3]), dispatch.numpy())
    if act == "sigmoid" and npe:
        assert np.array_equal(np.asarray(want[1]), gates.numpy())
    else:
        # float mode's sigmoid and exp are other implementations than XLA's,
        # and a softmax router's probabilities sum E exponentials in another
        # order: a gate may move by a float32 ulp or two
        np.testing.assert_allclose(gates.numpy(), np.asarray(want[1]), rtol=GATE_RTOL, atol=0)
    assert _err(want[0], got[0]) <= FLOAT_TOL
    cap = tn.moe_capacity(pcfg, S)
    assert cap == rn.moe_capacity(rcfg, S) and tuple(dispatch.shape) == (2, E, cap, 16)
    # a token-slot is dropped when more choices than C land on one expert
    counts = np.stack([np.bincount(r, minlength=E) for r in ids.reshape(2, -1).numpy()])
    return int(np.maximum(counts - cap, 0).sum())


BLOCK_SWEEP = [(E, k, S, cf, act, npe)
               for E, ks in ((4, (1, 2)), (8, (1, 2)), (32, (8,)))
               for k in ks
               for S, cf in ((16, 1.25), (24, 0.5))
               for act in ("softmax", "sigmoid")
               for npe in (False, True)]


@pytest.mark.parametrize("E,k,S,cf,act,npe", BLOCK_SWEEP)
def test_moe_block_routing_bit_for_bit(E, k, S, cf, act, npe):
    _check_block(E, k, S, cf, act, npe, seed=E * 100 + k * 10 + S)


def test_moe_block_sweep_drops():
    """The sweep's capacity factor 0.5 drops token-slots."""
    assert _check_block(8, 2, 24, 0.5, "softmax", True, seed=1) > 0


@settings(max_examples=25, deadline=None, database=None)
@given(E=st.sampled_from([2, 4, 8, 16]), k_frac=st.floats(0.0, 1.0), S=st.integers(1, 32),
       cf=st.floats(0.1, 3.0), act=st.sampled_from(["softmax", "sigmoid"]),
       npe=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_moe_block_routing_drawn(E, k_frac, S, cf, act, npe, seed):
    _check_block(E, 1 + int(k_frac * (E - 1)), S, cf, act, npe, seed)

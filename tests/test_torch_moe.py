"""The port's MoE block (`repro_torch.models.moe`) and MoE decoders against
the reference's (`repro.models.moe`, `repro.models.registry`) on the CPU.

  * Routing decisions exactly: on the same router probabilities, the expert
    ids (the lower index first among equal values, as `jax.lax.top_k`), the
    gates (renormalized over the top k for a softmax router) and the
    dispatch (`dispatch_mask`: each choice's slot in its expert and the
    capacity drops) equal the reference's, over a deterministic sweep of E,
    k, capacity factor, router kind and probabilities rounded to a coarse
    grid (many ties), and over hypothesis draws; the whole route from x
    (router product, router function, float and NPE) with random and with
    duplicated router columns (exact ties).
  * The index gather and scatter of `apply` give the bits of the reference's
    one-hot dispatch and combine products, in float32 and bf16.
  * granite_moe_1b_a400m (MoE every layer, softmax top-2 of 4 at smoke size)
    and llama4_maverick_400b_a17b (interleave 2: a dense layer then an MoE
    one, a sigmoid top-1 router, a shared expert) at smoke size: `apply`
    and a 7-token prefill plus 3 steps against the reference in float,
    NPE-8 and NPE-16, with the gates of tests/_torch_decoders.py.
  * `param_count` of the four configs this slice adds equals the
    reference's; `load_balance_loss` equals it within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_decoders as td
from _hypothesis_compat import given, settings, st
from repro.config import MoEConfig as RefMoEConfig
from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro_torch.config import MoEConfig
from repro_torch.configs import get_config
from repro_torch.models import moe, registry, transformer

torch.set_float32_matmul_precision("highest")

ARCHS = ["granite_moe_1b_a400m", "llama4_maverick_400b_a17b"]


def _moe_cfgs(E, k, cf, act, npe=False, d_model=16, d_ff=8):
    """(reference, port) granite-shaped configs of one MoE layer."""
    out = []
    for get, moe_cls in ((ref_get_config, RefMoEConfig), (get_config, MoEConfig)):
        c = dataclasses.replace(get("granite_moe_1b_a400m", smoke=True), dtype="float32",
                                num_layers=1, d_model=d_model, d_ff=d_ff,
                                moe=moe_cls(num_experts=E, top_k=k, capacity_factor=cf,
                                            router_act=act))
        out.append(c.with_npe(8) if npe else c)
    return out


def _ref_route(rcfg, probs):
    """The reference's steps 2-3 of `moe.apply` on probabilities (b, s, E)."""
    m = rcfg.moe
    b, s, E = probs.shape
    gv, ids = jax.lax.top_k(jnp.asarray(probs), m.top_k)
    if m.router_act == "softmax" and m.top_k > 1:
        gv = ref_moe.renormalize_gates(gv)
    cap = max(1, int(s * m.top_k / E * m.capacity_factor))
    disp = ref_moe.dispatch_mask(ids.reshape(b, s * m.top_k), E, cap)
    return np.asarray(gv), np.asarray(ids), np.asarray(disp), cap


def _port_dispatch(ids, slot, kept, E, cap):
    """The (b, t, E, C) one-hot of the port's slots: 1 at [b, t, id, slot] if kept."""
    b, t = ids.shape
    out = torch.zeros(b, t, E, cap)
    bi, ti = torch.nonzero(kept, as_tuple=True)
    out[bi, ti, ids[kept], slot[kept]] = 1.0
    return out.numpy()


def _check_decisions(probs, E, k, cf, act):
    rcfg, cfg = _moe_cfgs(E, k, cf, act)
    want_g, want_ids, want_disp, cap = _ref_route(rcfg, probs)
    b, s, _ = probs.shape
    gv, ids = moe.top_k(torch.from_numpy(probs), k)
    if act == "softmax" and k > 1:
        gv = moe.renormalize_gates(gv)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(gv.numpy(), want_g, rtol=2 ** -23 * k, atol=0)
    flat = ids.reshape(b, s * k)
    slot, kept = moe.dispatch_slots(flat, E, cap)
    assert np.array_equal(_port_dispatch(flat, slot, kept, E, cap), want_disp)
    assert np.array_equal(moe.dispatch_mask(flat, E, cap).numpy(), want_disp)
    return int((~kept).sum())


def _probs(rng, b, s, E, act, grid):
    logits = rng.standard_normal((b, s, E)).astype(np.float32)
    p = np.array(jax.nn.sigmoid(logits) if act == "sigmoid" else jax.nn.softmax(logits, -1))
    return (np.round(p * grid) / grid).astype(np.float32) if grid else p


SWEEP = [(E, k, cf, act, s, grid)
         for E, ks in ((4, (1, 2)), (8, (1, 2, 8)), (32, (1, 8)))
         for k in ks
         for cf in (0.5, 1.25, 2.0)
         for act in ("softmax", "sigmoid")
         for s, grid in ((16, 0), (120, 8))]


@pytest.mark.parametrize("E,k,cf,act,s,grid", SWEEP)
def test_routing_decisions_sweep(E, k, cf, act, s, grid):
    """Ids, gates and dispatch on the same probabilities; `grid` rounds them
    to multiples of 1/grid, so most choices are ties.  Some cells drop."""
    probs = _probs(np.random.default_rng(E * 1000 + k * 100 + s), 2, s, E, act, grid)
    _check_decisions(probs, E, k, cf, act)


def test_sweep_drops_and_ties():
    """The sweep's cells do drop and do tie: granite's 120-token prefill (E
    32, k 8, C 37) drops, and grid 8 ties most top-k choices."""
    probs = _probs(np.random.default_rng(0), 1, 120, 32, "softmax", 0)
    assert _check_decisions(probs, 32, 8, 1.25, "softmax") > 0
    tied = _probs(np.random.default_rng(1), 1, 120, 8, "sigmoid", 8)
    top = np.sort(tied, -1)[..., ::-1]
    assert (top[..., 0] == top[..., 1]).mean() > 0.3


@settings(max_examples=25, deadline=None, database=None)
@given(E=st.sampled_from([2, 4, 8, 16, 32]), k_frac=st.floats(0.0, 1.0),
       s=st.integers(1, 64), cf=st.floats(0.1, 3.0),
       act=st.sampled_from(["softmax", "sigmoid"]), grid=st.sampled_from([0, 4, 16]),
       seed=st.integers(0, 2 ** 16))
def test_routing_decisions_drawn(E, k_frac, s, cf, act, grid, seed):
    k = 1 + int(k_frac * (E - 1))
    _check_decisions(_probs(np.random.default_rng(seed), 2, s, E, act, grid), E, k, cf, act)


@pytest.mark.parametrize("npe", [False, True])
@pytest.mark.parametrize("act,k", [("softmax", 2), ("softmax", 8), ("sigmoid", 1)])
@pytest.mark.parametrize("dup", [False, True])
def test_route_from_x_matches_reference(npe, act, k, dup):
    """The whole route from x: the float32 router product, the router
    function (the NVU softmax or the PWL sigmoid in NPE mode), top-k,
    gates and drops, against the reference's `apply` steps; with `dup`,
    router columns 2j+1 copy columns 2j, so their logits tie exactly and
    the lower index must come first."""
    E, s = 8, 40
    rcfg, cfg = _moe_cfgs(E, k, 1.0, act, npe=npe, d_model=64)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    router = (0.3 * rng.standard_normal((64, E))).astype(np.float32)
    if dup:
        router[:, 1::2] = router[:, 0::2]
    p = moe.MoE(cfg, device="cpu")
    p.router.copy_(torch.from_numpy(router))
    r = moe.route(cfg, p, torch.from_numpy(x))
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(router))
    want_g, want_ids, want_disp, cap = _ref_route(rcfg, np.asarray(
        ref_moe._router_probs(rcfg, logits)))
    assert r.capacity == cap
    assert np.array_equal(r.expert_ids.numpy(), want_ids.reshape(2, s * k))
    assert np.array_equal(_port_dispatch(r.expert_ids, r.slot, r.kept, E, cap), want_disp)
    # the router product sums in another order and exp is another
    # implementation: a gate (<= 1) moves by a few float32 ulps
    np.testing.assert_allclose(r.gates.numpy(), want_g.reshape(2, s * k), rtol=0, atol=1e-6)
    if dup:
        pairs = want_ids.reshape(-1, k)
        assert (pairs[:, 0] % 2 == 0).all() and (k == 1 or (pairs[:, 1] == pairs[:, 0] + 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_gather_scatter_is_the_one_hot_products(dtype, shared):
    """`apply`'s index scatter and gather against the reference's one-hot
    einsums written in torch on the port's own `dispatch_mask`: the same
    bits (each dispatch and combine sum has one nonzero term)."""
    _, cfg = _moe_cfgs(4, 2, 0.75, "softmax", d_model=32, d_ff=16)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shared_expert=shared))
    p = moe.MoE(cfg, device="cpu", dtype=dtype)
    g = torch.Generator().manual_seed(3)
    for t in p.parameters():
        t.copy_(torch.randn(t.shape, generator=g) * 0.3)
    x = torch.randn(3, 24, 32, generator=g).to(dtype)
    got = moe.apply(cfg, p, x)
    r = moe.route(cfg, p, x)
    assert int((~r.kept).sum()) > 0                        # some choices drop
    disp = moe.dispatch_mask(r.expert_ids, 4, r.capacity).to(dtype)
    x_rep = x.repeat_interleave(2, dim=1)
    buf = torch.einsum("btec,btd->becd", disp, x_rep)
    act = torch.nn.functional.silu(torch.einsum("becd,edf->becf", buf, p.wg))
    out_buf = torch.einsum("becf,efd->becd", act * torch.einsum("becd,edf->becf", buf, p.wu),
                           p.wd)
    gated = disp * r.gates.to(dtype)[..., None, None]
    want = torch.einsum("btec,becd->btd", gated, out_buf).reshape(3, 24, 2, 32).sum(2)
    if shared:
        sp = p.shared
        want = want + (torch.nn.functional.silu(x @ sp.wg) * (x @ sp.wu)) @ sp.wd
    assert got.dtype == dtype and torch.equal(got, want)


# --- the MoE decoders -------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return (request.param, *td.load(request.param))


@pytest.mark.parametrize("mode", list(td.MODES))
def test_apply_matches_reference(weights, mode):
    arch, params, model = weights
    rcfg, cfg = td.cfgs(arch, mode)
    tok = td.tokens(12)
    want = td.ref_apply(rcfg, params, tok)
    noise = float(np.abs(td.ref_apply(rcfg, td.nudge(params), tok) - want).max())
    got = td.port_apply(cfg, model, tok)
    assert got.shape == want.shape == (2, 12, 512)
    diff = np.abs(got - want)
    assert td.gate(mode, diff, noise), (arch, mode, float(diff.max()), noise)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", list(td.MODES))
def test_decode_matches_reference(weights, mode):
    """A 7-token prefill in one call (full attention), then 3 greedy steps."""
    arch, params, model = weights
    cache = td.check_decode(arch, mode, params, model, td.tokens(7, seed=1), 3, 16)
    assert list(cache) == ["full"]


def test_layers_and_params():
    """granite: an MoE block in every layer and no dense MLP stack; llama4:
    dense, MoE, dense, ... with the shared expert; the state dict from the
    reference's tree fills every parameter."""
    for arch, flags in (("granite_moe_1b_a400m", [True, True]),
                        ("llama4_maverick_400b_a17b", [False, True])):
        cfg = get_config(arch, smoke=True)
        assert transformer.layer_is_moe(cfg).tolist() == flags
        model = registry.build_model(cfg, device="meta")
        for layer, is_moe in zip(model.layers, flags):
            assert hasattr(layer, "moe") == is_moe and hasattr(layer, "mlp") != is_moe
            if is_moe:
                assert hasattr(layer.moe, "shared") == cfg.moe.shared_expert
    assert transformer.layer_is_moe(get_config("llama4_maverick_400b_a17b")).sum() == 24


@pytest.mark.parametrize("arch", ["starcoder2_3b", "gemma3_27b", "granite_moe_1b_a400m",
                                  "llama4_maverick_400b_a17b"])
def test_param_count_matches_reference(arch):
    assert get_config(arch).param_count() == ref_registry.param_count(ref_get_config(arch))
    assert dataclasses.asdict(get_config(arch, smoke=True)) == \
        dataclasses.asdict(ref_get_config(arch, smoke=True))


def test_init_scales_of_the_moe_weights():
    """The router is drawn at 0.02, the expert stacks at fan_in^-0.5 of
    their second-to-last axis, as the reference's `_init_leaf`."""
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    model = registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p = model.layers[0].moe
    for t, want in ((p.router, 0.02), (p.wg, cfg.d_model ** -0.5), (p.wd, cfg.d_ff ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.1


def test_load_balance_loss_matches_reference():
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 4)).astype(np.float32)
    ids = rng.integers(0, 4, (64, 2))
    want = float(ref_moe.load_balance_loss(ref_get_config("granite_moe_1b_a400m", smoke=True),
                                           jnp.asarray(logits), jnp.asarray(ids)))
    got = float(moe.load_balance_loss(cfg, torch.from_numpy(logits), torch.from_numpy(ids)))
    assert abs(got - want) <= 1e-6

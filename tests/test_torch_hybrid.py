"""The port's Mamba head (`repro_torch.models.ssm`) and Hymba hybrid
(`repro_torch.models.hybrid`) against the reference's (`repro.models.ssm`,
`repro.models.hybrid`) on the smoke config of hymba_1_5b: 2 layers (layer 0
local over a window of 32, layer 1 global), D=128, 4 query heads over 2
kv heads of 32, a Mamba head of d_inner 256 and state 16, 128 meta tokens,
vocabulary 512, float32, the reference's `init_params` with seeded noise on
every weight, in float, NPE-8 and NPE-16.

The reference runs op by op (`jax.disable_jit()`), as the port does; gates
as in tests/_torch_decoders.py (float within twice the reference's change
under a 1-ulp weight nudge, NPE 5e-3 or, for NPE-8, twice the nudged
change, the same greedy tokens, every cache
tensor within one bf16 ulp or twice the nudged change).  Decode runs over a
ring cut to 8 rows, past its wrap.  The reference's `decode_step` does not
prepend the meta tokens that its `apply` does: decode is the forward of the
same model without them, which the port keeps and the last tests show.

Decode rounds the cache and the attention probabilities to bf16.  The
two packages' float32 queries differ in their last places from the first
layer on (the projections' and RoPE's float32 sums run in another order
in XLA than in PyTorch: 7e-7 at |q| = 3.8 in the first call), so the
scores differ by an ulp or two, and at the decode's positions 5 and 6 one
probability rounds to the other bf16 neighbour on the two sides.  With
noise of 0.05 on the weights that one flip moves those logits by 4.8e-3,
where the other archs' smoke logits move by about 2e-5 (`BF16_FLIP`).
The reference does the same to itself: weights one ulp down move its
float logits by 4.4e-3 (one ulp up by 3.6e-5, and flips none), and in
NPE-16 one ulp up leaves 2.3 % of its logits more than 5e-3 from its own.
So the decode test nudges the reference both ways (`check_decode`'s
`both_ways`) and holds the port to twice the larger change; with float32
caches on both sides (nothing rounds to bf16) the float run agrees within
2.6e-5 under the one-way gate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import npec as ref_npec
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro_torch import npec
from repro_torch.configs import get_config
from repro_torch.models import hybrid, registry, ssm
from _torch_decoders import (MODES, check_decode, cfgs, gate, load, nudge, port_apply,
                             port_decode, ref_apply, tokens)
from _torch_families import ref_float32, serve_both  # noqa: F401

torch.set_float32_matmul_precision("highest")

ARCH = "hymba_1_5b"
PROMPT, STEPS, JITTER = 10, 3, 0.05
RING = dict(window=8)            # decode: an 8-row ring, written past its wrap


@pytest.fixture(scope="module")
def weights():
    return load(ARCH, jitter=JITTER)


@pytest.fixture
def float32_caches(monkeypatch):
    """KV caches in float32 on both sides (the reference's
    `kv_cache_specs` default dtype, the port's `CACHE_DTYPE`)."""
    from repro.models import common as ref_cm
    from repro_torch.models import common as cm
    monkeypatch.setattr(ref_cm.kv_cache_specs, "__defaults__", ("float32",))
    monkeypatch.setattr(cm, "CACHE_DTYPE", torch.float32)


def test_configs_equal_reference_field_for_field():
    for smoke in (False, True):
        ref, got = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert cfgs(ARCH)[1] == dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    assert registry.param_count(get_config(ARCH)) == ref_registry.param_count(
        ref_get_config(ARCH)) == 1_663_284_800
    assert ssm.dims(get_config(ARCH)) == ref_ssm.dims(ref_get_config(ARCH)) == (3200, 16, 100)
    assert registry.has_decode(get_config(ARCH))
    assert registry.module_for(get_config(ARCH)) is hybrid


@pytest.mark.parametrize("mode", list(MODES))
def test_mamba_head_matches_reference(weights, mode):
    """`ssm.apply_layer` of layer 0 on a (2, 7, 128) input from a nonzero scan
    state and conv state: the output, the new float32 state and the conv
    state against the reference's."""
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode)
    rng = np.random.default_rng(3)
    di, N, _ = ssm.dims(cfg)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    st = (0.1 * rng.standard_normal((2, di, N))).astype(np.float32)
    cv = rng.standard_normal((2, 3, di)).astype(np.float32)

    def ref(p):
        p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), p["blocks"]["ssm"])
        with jax.disable_jit():
            return [np.asarray(a) for a in ref_ssm.apply_layer(
                rcfg, p0, jnp.asarray(x), jnp.asarray(st), jnp.asarray(cv))]

    want, noisy = ref(params), ref(nudge(params))
    got = [t.numpy() for t in ssm.apply_layer(cfg, model.layers[0].ssm, torch.from_numpy(x),
                                              torch.from_numpy(st), torch.from_numpy(cv))]
    for name, g, w, n in zip(("out", "state", "conv"), got, want, noisy):
        assert g.shape == w.shape and g.dtype == np.float32, name
        diff, noise = np.abs(g - w), float(np.abs(n - w).max())
        assert gate(mode, diff, noise, npe8_noise=True), (
            name, mode, float(diff.max()), noise)


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_matches_reference(weights, mode):
    """The forward with the 128 meta tokens ahead of 6 tokens (134 rows over
    layer 0's window of 32), their logits dropped."""
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode)
    tok = tokens(6)
    want = ref_apply(rcfg, params, tok)
    got = port_apply(cfg, model, tok)
    noise = float(np.abs(ref_apply(rcfg, nudge(params), tok) - want).max())
    diff = np.abs(got - want)
    assert got.shape == want.shape == (2, 6, 512)
    assert gate(mode, diff, noise, npe8_noise=True), (mode, float(diff.max()), noise)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_over_a_wrapped_ring_matches_reference(weights, mode):
    """A 10-token prompt one token a call and 3 steps over layer 0's 8-row
    ring (positions 0..12: the ring is written past its wrap) and layer 1's
    full rows: logits, greedy tokens, the `full`/`win` KV groups and the
    `ssm`/`conv` states against the reference's."""
    params, model = weights
    cache = check_decode(ARCH, mode, params, model, tokens(PROMPT, seed=1), STEPS, 16,
                         npe8_noise=True, both_ways=True, **RING)
    assert set(cache) == {"full", "win", "ssm", "conv"}
    assert cache["win"]["k"].shape == (1, 2, 8, 2, 32)
    assert cache["ssm"].shape == (2, 2, 256, 16) and cache["conv"].shape == (2, 2, 3, 256)


def test_float_decode_with_float32_caches_matches_reference(weights, float32_caches):
    params, model = weights
    cache = check_decode(ARCH, "float", params, model, tokens(PROMPT, seed=1), STEPS, 16, **RING)
    assert cache["win"]["k"].dtype == np.float32


def test_cache_specs_match_reference():
    rcfg, cfg = cfgs(ARCH, **RING)
    specs = hybrid.cache_specs(dataclasses.replace(cfg, dtype="bfloat16"), 3, 16)
    ref_specs = ref_registry.cache_specs(dataclasses.replace(rcfg, dtype="bfloat16"), 3, 16)
    assert set(specs) == set(ref_specs) == {"full", "win", "ssm", "conv"}
    for group in ("full", "win"):
        for name in ("k", "v"):
            assert specs[group][name] == (ref_specs[group][name].shape, torch.bfloat16)
    assert specs["ssm"] == (ref_specs["ssm"].shape, torch.float32)
    assert specs["conv"] == (ref_specs["conv"].shape, torch.bfloat16)


def test_decode_omits_the_meta_tokens(weights, float32_caches):
    """Decode token by token (float32 caches) is the forward without meta
    tokens, within float32 noise, and not the forward with them: the
    reference's `decode_step` starts at position 0 with no meta tokens, and
    the port follows it (the decode tests above hold the two decodes
    together)."""
    params, model = weights
    _, cfg = cfgs(ARCH, **RING)
    tok = tokens(PROMPT, seed=1)
    logits, _, _ = port_decode(cfg, model, tok, 0, 16, None)
    dec = np.concatenate(logits, 1)
    with_meta = port_apply(cfg, model, tok)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hybrid, "meta_tokens", lambda c: 0)
        without = port_apply(cfg, model, tok)
    assert np.abs(dec - without).max() < 1e-4
    assert np.abs(dec - with_meta).max() > 1e-1


def test_server_generate_matches_reference_server(ref_float32):
    """`Server.generate` (3 slots, prompts of 5-9 tokens one a call, over a
    24-row ring and full rows) gives the reference server's tokens, and its
    SSM states are the reference's."""
    want, got, ref_cache, cache = serve_both(ARCH)
    np.testing.assert_array_equal(got, want)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(cache[name], ref_cache[name], atol=1e-4, rtol=1e-4)


def test_npec_refuses_the_family_as_the_reference():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ref_npec.CompileError, match="ROADMAP"):
        ref_npec.trace_model(ref_get_config(ARCH, smoke=True), 16)
    with pytest.raises(npec.CompileError, match="ROADMAP") as ei:
        npec.trace_model(cfg, 16)
    assert cfg.family in str(ei.value)
    for trace in (lambda: npec.trace_decode(cfg, 16), lambda: npec.trace_prefill(cfg, 8)):
        with pytest.raises(npec.CompileError):
            trace()

"""The port's encoder-decoder (`repro_torch.models.encdec`) against the
reference's (`repro.models.encdec`) on the smoke config of whisper_base: 2
encoder and 2 decoder layers, D=128, 4 query heads over 2 kv heads of 32,
64 encoder frames, LayerNorm with bias, qkv and MLP biases, GELU, learned
decoder positions (256), a tied head, vocabulary 512, float32, the
reference's `init_params` with seeded noise on every weight (its biases and
betas start at zero), in float, NPE-8 and NPE-16, on seeded frame
embeddings (the audio front end is a stub on both sides).

The reference runs op by op (`jax.disable_jit()`), as the port does; gates
as in tests/_torch_decoders.py, NPE-8 also within twice the nudged
reference's change (its decode logits move by 0.032 under a 1-ulp weight
nudge, an int8 step).  The encoder is causal on both sides (the
reference's `cfg.causal` reaches its `attention_auto`); the cross-attention
sees every encoder row.  Decode fills the `cross` cache from
`init_cross_cache` first, as tests/test_archs_smoke.py does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import npec as ref_npec
from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import registry as ref_registry
from repro_torch import npec
from repro_torch.configs import get_config
from repro_torch.models import encdec, registry
from repro_torch.models.convert import cache_from_jax
from _torch_decoders import (MODES, bf16_ulp, check_decode, cfgs, gate, load, nudge, tokens,
                             ref_cross_cache)
from _torch_families import frames, ref_float32, serve_both  # noqa: F401

torch.set_float32_matmul_precision("highest")

ARCH = "whisper_base"
SMOKE = dict(max_position=256)          # whisper's smoke_config over shrink
JITTER = 0.05


@pytest.fixture(scope="module")
def weights():
    return load(ARCH, jitter=JITTER, **SMOKE)


@pytest.fixture(scope="module")
def fr():
    return frames(cfgs(ARCH, **SMOKE)[1], 2)


def test_configs_equal_reference_field_for_field():
    for smoke in (False, True):
        ref, got = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert cfgs(ARCH, **SMOKE)[1] == dataclasses.replace(get_config(ARCH, smoke=True),
                                                         dtype="float32")
    assert registry.param_count(get_config(ARCH)) == ref_registry.param_count(
        ref_get_config(ARCH)) == 87_516_160
    assert registry.has_decode(get_config(ARCH))
    assert registry.module_for(get_config(ARCH)) is encdec


def _ref(fn, rcfg, params, *args):
    with jax.disable_jit():
        return np.asarray(fn(rcfg, params, *[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("mode", list(MODES))
def test_encode_matches_reference(weights, fr, mode):
    """The encoder (sinusoidal positions, causal self-attention, ln_enc) over
    the 64 seeded frames."""
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode, **SMOKE)
    want = _ref(ref_encdec.encode, rcfg, params, fr)
    noise = float(np.abs(_ref(ref_encdec.encode, rcfg, nudge(params), fr) - want).max())
    got = encdec.encode(cfg, model, torch.from_numpy(fr)).numpy()
    diff = np.abs(got - want)
    assert got.shape == want.shape == (2, 64, 128)
    assert gate(mode, diff, noise, npe8_noise=True), (mode, float(diff.max()), noise)


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_cache_matches_reference(weights, fr, mode):
    """`init_cross_cache`: every decoder layer's cross k/v of the encoder
    output, bf16, within one bf16 ulp or twice the nudged change."""
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode, **SMOKE)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_cross_cache(rcfg, params, fr))
    nud = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       ref_cross_cache(rcfg, nudge(params), fr))
    got = encdec.init_cross_cache(cfg, model, torch.from_numpy(fr))
    for name in ("k", "v"):
        g, w = got[name].float().numpy(), want[name]
        assert got[name].dtype == torch.bfloat16 and g.shape == w.shape == (2, 2, 64, 2, 32)
        n = 2 * float(np.abs(nud[name] - w).max())
        assert bool((np.abs(g - w) <= np.maximum(bf16_ulp(w) + 1e-6, n)).all()), name


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_matches_reference(weights, fr, mode):
    """The whole forward: the encoder, then the teacher-forced decoder over
    7 tokens (causal self-attention, cross-attention over every frame)."""
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode, **SMOKE)
    tok = tokens(7)

    def ref(p):
        with jax.disable_jit():
            return np.asarray(ref_registry.apply(rcfg, p, jnp.asarray(tok), remat=False,
                                                 extra_embeds=jnp.asarray(fr)))

    want = ref(params)
    noise = float(np.abs(ref(nudge(params)) - want).max())
    got = registry.apply(cfg, model, torch.from_numpy(tok).long(),
                         extra_embeds=torch.from_numpy(fr)).numpy()
    diff = np.abs(got - want)
    assert got.shape == want.shape == (2, 7, 512)
    assert gate(mode, diff, noise, npe8_noise=True), (mode, float(diff.max()), noise)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_matches_reference(weights, fr, mode):
    """The cross cache from `init_cross_cache`, a 6-token prompt one token a
    call and 3 steps: logits, greedy tokens, the `self` and `cross` caches."""
    params, model = weights
    cache = check_decode(ARCH, mode, params, model, tokens(6, seed=1), 3, 16, frames=fr,
                         npe8_noise=True, **SMOKE)
    assert set(cache) == {"self", "cross"}
    assert cache["self"]["k"].shape == (2, 2, 16, 2, 32)
    assert cache["cross"]["k"].shape == (2, 2, 64, 2, 32)


def test_cache_specs_match_reference():
    rcfg, cfg = cfgs(ARCH, **SMOKE)
    specs, ref_specs = encdec.cache_specs(cfg, 3, 16), ref_registry.cache_specs(rcfg, 3, 16)
    assert set(specs) == set(ref_specs) == {"self", "cross"}
    for group in specs:
        for name in ("k", "v"):
            assert specs[group][name] == (ref_specs[group][name].shape, torch.bfloat16)


def test_server_generate_matches_reference_server(ref_float32):
    """`Server.generate` (3 slots, prompts of 5-9 tokens one a call) with the
    same cross cache written into both servers (the reference's
    `init_cross_cache` of 3 seeded frame batches; the reference's server
    itself starts from a zero cross cache) gives the reference server's
    tokens."""
    def fill(server, is_ref):
        if is_ref:
            cfg = server.cfg
            fill.cross = jax.tree.map(np.asarray, ref_encdec.init_cross_cache(
                cfg, server.params, jnp.asarray(frames(cfg, 3, seed=4))))
            server.cache["cross"] = jax.tree.map(jnp.asarray, fill.cross)
        else:
            server.cache["cross"] = cache_from_jax(fill.cross)

    want, got, ref_cache, cache = serve_both(ARCH, fill=fill)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cache["cross"]["k"], ref_cache["cross"]["k"])


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

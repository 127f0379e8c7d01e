"""The port's RWKV6 (`repro_torch.models.rwkv6`) against the reference's
(`repro.models.registry`, family `ssm`) on the smoke config of rwkv6_3b:
2 layers, D=128, two heads of 64, d_ff 256, vocabulary 512, float32, the
reference's `init_params` with seeded noise on every weight (its zero
initialisers, the LoRA-b matrices, the decay offset and the bonus u, would
hide their paths), handed to the port through `params_from_jax`, in
float, NPE-8 and NPE-16.

The reference runs op by op (`jax.disable_jit()`), as the port does.
Gates (tests/_torch_decoders.py): float within twice the reference's own
change under a 1-ulp weight nudge; NPE within 5e-3, NPE-8 also within
twice the nudged reference's change (an int8 step that a 1-ulp weight
moves); the same greedy tokens; the recurrent state (float32 WKV state, token-shift inputs) within
one bf16 ulp or twice the nudged reference's change.  Decode token by
token must give the teacher-forced forward (the reference's
`test_decode_matches_forward_rwkv`, 2e-2 in bf16).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import npec as ref_npec
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro_torch import npec
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import registry, rwkv6
from repro_torch.models.convert import cache_from_jax, cache_to_numpy
from _torch_decoders import (MODES, check_decode, cfgs, gate, load, nudge, port_apply,
                             ref_apply, tokens)
from _torch_families import ref_float32, serve_both  # noqa: F401

torch.set_float32_matmul_precision("highest")

ARCH = "rwkv6_3b"
SMOKE = dict(num_heads=2, head_dim=64)          # rwkv6's smoke_config over shrink
PROMPT, STEPS, JITTER = 6, 3, 0.05


@pytest.fixture(scope="module")
def weights():
    return load(ARCH, jitter=JITTER, **SMOKE)


def test_configs_equal_reference_field_for_field():
    for smoke in (False, True):
        ref, got = ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert cfgs(ARCH, **SMOKE)[1] == dataclasses.replace(get_config(ARCH, smoke=True),
                                                         dtype="float32")
    assert registry.param_count(get_config(ARCH)) == ref_registry.param_count(
        ref_get_config(ARCH)) == 3_099_863_040
    assert registry.has_decode(get_config(ARCH)) and registry.module_for(
        get_config(ARCH)) is rwkv6


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_matches_reference(weights, mode):
    params, model = weights
    rcfg, cfg = cfgs(ARCH, mode, **SMOKE)
    tok = tokens(PROMPT)
    want = ref_apply(rcfg, params, tok)
    got = port_apply(cfg, model, tok)
    noise = float(np.abs(ref_apply(rcfg, nudge(params), tok) - want).max())
    diff = np.abs(got - want)
    assert got.shape == want.shape == (2, PROMPT, 512)
    assert gate(mode, diff, noise, npe8_noise=True), (mode, float(diff.max()), noise)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_and_state_match_reference(weights, mode):
    """Token-by-token prefill and 3 steps: logits, greedy tokens and the
    whole state tree (`state`, `x_att`, `x_ffn`) against the reference's."""
    params, model = weights
    cache = check_decode(ARCH, mode, params, model, tokens(PROMPT, seed=1), STEPS, 16,
                         npe8_noise=True, **SMOKE)
    assert set(cache) == {"state", "x_att", "x_ffn"}
    assert cache["state"].shape == (2, 2, 2, 64, 64)


def test_cache_specs_dtypes_and_round_trip():
    rcfg, cfg = cfgs(ARCH, **SMOKE)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    specs = rwkv6.cache_specs(bf, 3, 8)
    ref_specs = ref_registry.cache_specs(dataclasses.replace(rcfg, dtype="bfloat16"), 3, 8)
    for name, (shape, dtype) in specs.items():
        assert shape == ref_specs[name].shape
        assert dtype == (torch.float32 if ref_specs[name].dtype == "float32" else torch.bfloat16)
    rng = np.random.default_rng(0)
    tree = {name: np.asarray(rng.standard_normal(s.shape), s.dtype if s.dtype == "float32"
                             else jax.numpy.bfloat16) for name, s in ref_specs.items()}
    cache = cache_from_jax(tree)
    assert cache["state"].dtype == torch.float32 and cache["x_att"].dtype == torch.bfloat16
    back = cache_to_numpy(cache)
    for name in tree:
        assert np.array_equal(back[name], np.asarray(tree[name], np.float32))


def test_decode_matches_forward_bf16():
    """Decode one token a call reproduces the teacher-forced forward, in the
    model's bf16 (the reference's tolerance, 2e-2)."""
    cfg = get_config(ARCH, smoke=True)
    model = registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tok = torch.as_tensor(tokens(6, seed=2, batch=1)).long()
    full = registry.apply(cfg, model, tok).float()
    cache = registry.init_cache(cfg, 1, 6, "cpu")
    dec = torch.cat([registry.decode_step(cfg, model, cache, tok[:, t:t + 1], t)[0]
                     for t in range(6)], 1).float()
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def test_groupnorm_rsqrt_and_exp_through_the_pwl_table():
    """NPE mode's group-norm 1/sqrt is the reference's `nvu_rsqrt` (the table
    on the power-of-4 mantissa) and Mamba's decay its `nvu_exp` (floored at
    0): on the CPU, `ops.pwl_rsqrt` and `ops.pwl_exp` equal the port's
    `core/nvu` functions bit for bit and the reference's within 1e-6."""
    from repro.core import nvu as ref_nvu
    from repro_torch.core import nvu
    x = torch.logspace(-6, 4, 997, dtype=torch.float32)[None]
    z = torch.linspace(-30, 2, 1001)[None]
    for fn, ref, want, arg in ((ops.pwl_rsqrt, ref_nvu.nvu_rsqrt, nvu.nvu_rsqrt, x),
                               (ops.pwl_exp, ref_nvu.nvu_exp, nvu.nvu_exp, z)):
        got = fn(arg)
        assert torch.equal(got, want(arg))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref(jax.numpy.asarray(arg.numpy()))),
                                   rtol=1e-6, atol=1e-6)
    assert bool((ops.pwl_exp(z) >= 0).all())


def test_server_generate_matches_reference_server(ref_float32):
    """`Server.generate` on 3 slots (prompts of 5-9 tokens, one token a
    call, as the reference's server prefills a cache that is not a `full`
    KV group alone) gives the reference server's tokens, and the states
    written through each slot's views are the reference's."""
    want, got, ref_cache, cache = serve_both(ARCH)
    np.testing.assert_array_equal(got, want)
    for name in ("state", "x_att", "x_ffn"):
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

"""The port's decoder (`repro_torch.models.transformer`) against the
reference's (`repro.models.registry.apply` / `decode_step`) on the smoke
configs of glm4_9b (GQA, RMSNorm, SwiGLU, qkv bias, RoPE, untied head),
command_r_plus_104b (parallel block, bias-free LayerNorm, qk-norm, tied
head) and qwen2_vl_7b (M-RoPE, the vision stub's patch embeddings):
2 layers, D=128, 4 q-heads over 2 kv-heads, vocabulary 512, float32
weights and activations from the reference's `init_params` through
`params_from_jax`, in float, NPE-8 and NPE-16.

The reference runs under `jax.disable_jit()`, op by op, as the port does.
Compiled (its layers are a `lax.scan`), XLA fuses and reorders float
operations; at 8 bits one such rounding can move an activation across an
int8 boundary, and the compiled reference then moves its own logits by as
much as its 1-ulp weight nudge does (0.16 on glm4's smoke logits of up to
3.8): a measure of the reference's noise, not a gate.

Gates:
  * float: within twice the reference's own change under a 1-ulp weight
    nudge (measured here; about 4e-6);
  * NPE-8 and NPE-16: within the reference's NPE gate, 5e-3
    (tests/conftest.py), every logit;
  * NPE-16 decode, past the bf16 cache: at least 99% of the logits within
    5e-3 and every one within twice the nudged reference's change.  Its
    product is a float32 matmul on the int16 grid, whose summation order
    differs between XLA and torch; an ulp there moves an activation across an
    int16 step now and then, and that one across a bf16 step of the cache.
    The reference moves as far by itself: compiled, its NPE-16 decode logits
    differ from its op-by-op run by up to 7.3e-3 on glm4 and 1.0e-2 on
    qwen2-vl (the port's: 6.5e-3 and 1.2e-2, with 0.09% and 0.5% of the
    logits past 5e-3);
  * the same greedy tokens in every mode;
  * decode: the prefill's and every step's logits as above, the KV cache
    within one bf16 ulp or the nudged reference's change;
  * decode against the port's own teacher-forced forward (as the reference's
    `test_decode_matches_forward_dense`): 2e-2 in bf16, its tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as RefMoEConfig
from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro_torch.config import MoEConfig
from repro_torch.configs import get_config, shrink
from repro_torch.models import common as cm
from repro_torch.models import registry, transformer
from repro_torch.models.convert import cache_to_numpy, params_from_jax
from repro_torch.models.transformer import Transformer

torch.set_float32_matmul_precision("highest")

ARCHS = ["glm4_9b", "command_r_plus_104b", "qwen2_vl_7b"]
MODES = {"float": lambda c: c, "npe8": lambda c: c.with_npe(8),
         "npe16": lambda c: c.with_npe(16)}
NPE_TOL, FACTOR, NPE16_BULK = 5e-3, 2.0, 0.99
PROMPT, STEPS, MAX_SEQ = 7, 3, 16


def _cfgs(arch, mode="float"):
    f32 = lambda c: dataclasses.replace(c, dtype="float32")   # noqa: E731
    return (MODES[mode](f32(ref_get_config(arch, smoke=True))),
            MODES[mode](f32(get_config(arch, smoke=True))))


def _nudge(tree):
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(arch, the reference's float32 params, the port's model on them)."""
    rcfg, cfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(0)))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return request.param, params, model


def _tokens(n, seed=0, batch=2):
    return np.random.default_rng(seed).integers(0, 512, (batch, n)).astype(np.int32)


def _gate(mode, diff, noise, decode=False):
    """Whether |port - reference| of every logit, `diff`, passes: see the
    module's docstring."""
    if mode == "float":
        return diff.max() <= FACTOR * noise
    if mode == "npe16" and decode:
        return diff.max() <= FACTOR * noise and (diff <= NPE_TOL).mean() >= NPE16_BULK
    return diff.max() <= NPE_TOL


def _ref_apply(rcfg, params, tok, **kw):
    with jax.disable_jit():
        return np.asarray(ref_registry.apply(rcfg, params, jnp.asarray(tok), remat=False, **kw))


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_matches_reference(weights, mode):
    arch, params, model = weights
    rcfg, cfg = _cfgs(arch, mode)
    tok = _tokens(12)
    want = _ref_apply(rcfg, params, tok)
    noise = float(np.abs(_ref_apply(rcfg, _nudge(params), tok) - want).max())
    got = registry.apply(cfg, model, torch.from_numpy(tok).long()).numpy()
    assert got.shape == want.shape == (2, 12, 512)
    diff = np.abs(got - want)
    assert _gate(mode, diff, noise), (arch, mode, float(diff.max()), noise)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def _ref_decode(rcfg, params, tok, feed):
    """(prefill logits, step logits, greedy tokens, cache) of the
    reference: the prompt in one multi-token decode_step at 0, then STEPS
    single-token steps; steps after the first take `feed` where given."""
    cache = ref_cm.init_params(ref_registry.cache_specs(rcfg, tok.shape[0], MAX_SEQ),
                               jax.random.PRNGKey(0))
    logits, toks = [], []
    with jax.disable_jit():
        lg, cache = ref_registry.decode_step(rcfg, params, cache, jnp.asarray(tok), jnp.int32(0))
        logits.append(np.asarray(lg))
        cur = tok[:, -1:]
        for i in range(STEPS):
            lg, cache = ref_registry.decode_step(rcfg, params, cache, jnp.asarray(cur),
                                                 jnp.int32(PROMPT + i))
            logits.append(np.asarray(lg))
            toks.append(logits[-1][:, -1].argmax(-1))
            cur = (toks[-1] if feed is None else feed[:, i])[:, None].astype(np.int32)
    return logits, np.stack(toks, 1), jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def _port_decode(cfg, model, tok, feed):
    cache = registry.init_cache(cfg, tok.shape[0], MAX_SEQ, "cpu")
    lg, cache = registry.decode_step(cfg, model, cache, torch.from_numpy(tok).long(), 0)
    logits, toks = [lg.numpy()], []
    cur = torch.from_numpy(tok[:, -1:]).long()
    for i in range(STEPS):
        lg, cache = registry.decode_step(cfg, model, cache, cur, PROMPT + i)
        logits.append(lg.numpy())
        toks.append(logits[-1][:, -1].argmax(-1))
        cur = torch.from_numpy(feed[:, i:i + 1]).long()
    return logits, np.stack(toks, 1), cache_to_numpy(cache)


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_matches_reference(weights, mode):
    """A 7-token prefill and 3 steps for 2 slots, both sides fed the
    reference's greedy tokens."""
    arch, params, model = weights
    rcfg, cfg = _cfgs(arch, mode)
    tok = _tokens(PROMPT, seed=1)
    want_lg, want_tok, want_cache = _ref_decode(rcfg, params, tok, None)
    nud_lg, _, nud_cache = _ref_decode(rcfg, _nudge(params), tok, want_tok)
    got_lg, got_tok, got_cache = _port_decode(cfg, model, tok, want_tok)
    assert got_lg[0].shape == (2, PROMPT, 512) and got_lg[1].shape == (2, 1, 512)
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got_lg, want_lg)])
    noise = max(float(np.abs(n - w).max()) for n, w in zip(nud_lg, want_lg))
    assert _gate(mode, diff, noise, decode=True), (
        arch, mode, float(diff.max()), float((diff <= NPE_TOL).mean()), noise)
    assert np.array_equal(got_tok, want_tok)
    for name in ("k", "v"):
        g, w = got_cache["full"][name], want_cache["full"][name]
        assert g.shape == w.shape == (2, 2, MAX_SEQ, 2, 32)
        n = FACTOR * float(np.abs(nud_cache["full"][name] - w).max())
        assert bool((np.abs(g - w) <= np.maximum(_bf16_ulp(w), n)).all()), name
        assert not g[:, :, PROMPT + STEPS:].any()


@pytest.mark.parametrize("mode", ["float", "npe8"])
def test_plain_mlp_and_learned_positions(mode):
    """The decoder paths no ported config takes: learned positions and a
    plain GELU MLP with biases (set to random values), `apply` and prefill +
    3 steps against the reference, with the gates above."""
    over = dict(mlp_type="plain", mlp_bias=True, rope="learned", activation="gelu")
    rcfg = dataclasses.replace(_cfgs("glm4_9b")[0], **over)
    cfg = dataclasses.replace(_cfgs("glm4_9b")[1], **over)
    params = jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(9)
    for b in ("b1", "b2"):
        leaf = params["blocks"]["mlp"][b]
        params["blocks"]["mlp"][b] = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    rcfg, cfg = MODES[mode](rcfg), MODES[mode](cfg)
    tok = _tokens(12)
    want = _ref_apply(rcfg, params, tok)
    noise = float(np.abs(_ref_apply(rcfg, _nudge(params), tok) - want).max())
    diff = np.abs(registry.apply(cfg, model, torch.from_numpy(tok).long()).numpy() - want)
    assert _gate(mode, diff, noise), (mode, float(diff.max()), noise)
    tok = _tokens(PROMPT, seed=1)
    want_lg, want_tok, _ = _ref_decode(rcfg, params, tok, None)
    nud_lg, _, _ = _ref_decode(rcfg, _nudge(params), tok, want_tok)
    got_lg, got_tok, _ = _port_decode(cfg, model, tok, want_tok)
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got_lg, want_lg)])
    noise = max(float(np.abs(n - w).max()) for n, w in zip(nud_lg, want_lg))
    assert _gate(mode, diff, noise, decode=True), (mode, float(diff.max()), noise)
    assert np.array_equal(got_tok, want_tok)


@pytest.mark.parametrize("over", [{}, dict(attention="local_global", window=4096),
                                  dict(family="moe", moe=MoEConfig(num_experts=64, top_k=8)),
                                  dict(family="encdec", encoder_layers=12, decoder_layers=12,
                                       encoder_seq=1500, num_patches=256)])
@pytest.mark.parametrize("arch", ARCHS)
def test_shrink_matches_reference(arch, over):
    """`get_config(smoke=True)` and `shrink` of configs the port cannot build
    yet (MoE, local:global, encoder-decoder fields) equal the reference's
    field for field."""
    ref_over = dict(over, moe=RefMoEConfig(**dataclasses.asdict(over["moe"]))) \
        if "moe" in over else over
    got = shrink(dataclasses.replace(get_config(arch), **over))
    want = ref_shrink(dataclasses.replace(ref_get_config(arch), **ref_over))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(get_config(arch, smoke=True)) == \
        dataclasses.asdict(ref_get_config(arch, smoke=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token by token through the cache gives the teacher-forced forward's
    logits: the smoke config in bf16, the reference's tolerance 2e-2."""
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(8, seed=2, batch=1)).long()
    full = transformer.apply(cfg, model, tok)
    cache = transformer.init_cache(cfg, 1, 8, "cpu")
    outs = [transformer.decode_step(cfg, model, cache, tok[:, t:t + 1], t)[0][:, 0]
            for t in range(8)]
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(), full.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_vlm_patch_embeddings_and_mrope_sections():
    """qwen2-vl: patch embeddings ahead of the tokens; M-RoPE with distinct
    t/h/w ids against the reference's `apply_mrope` (1e-6: f32 cos/sin)."""
    rcfg, cfg = _cfgs("qwen2_vl_7b")
    params = jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(3)))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    tok = _tokens(6, seed=4)
    patches = np.random.default_rng(5).standard_normal((2, 4, 128)).astype(np.float32)
    want = _ref_apply(rcfg, params, tok, extra_embeds=jnp.asarray(patches))
    got = transformer.apply(cfg, model, torch.from_numpy(tok).long(),
                            extra_embeds=torch.from_numpy(patches)).numpy()
    assert got.shape == (2, 10, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    x = np.random.default_rng(6).standard_normal((2, 5, 3, 128)).astype(np.float32)
    pos3 = np.random.default_rng(7).integers(0, 300, (2, 5, 3)).astype(np.int32)
    np.testing.assert_allclose(
        cm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6).numpy(),
        np.asarray(ref_cm.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)),
        rtol=0, atol=1e-5)


def test_rope_and_rmsnorm_exact():
    """Standard RoPE at positions up to 4096 (1e-5: f32 angles, cos and sin
    may differ by an ulp); RMSNorm in bf16, whose bf16 x times an f32
    1/sqrt promotes to f32 in both packages (one bf16 ulp)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(ref_cm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), rtol=0, atol=1e-5)
    h = rng.standard_normal((3, 4096)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(4096)).astype(np.float32)
    hb, gb = torch.from_numpy(h).bfloat16(), torch.from_numpy(g).bfloat16()
    got = cm.rmsnorm_exact(hb, gb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref_cm.rmsnorm_exact(jnp.asarray(h).astype(jnp.bfloat16),
                                           jnp.asarray(g).astype(jnp.bfloat16)), np.float32)
    assert bool((np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("over", [dict(attention="sliding"),                 # starcoder2
                                  dict(attention="local_global"),            # gemma3
                                  dict(logit_softcap=50.0),
                                  dict(family="moe", moe=MoEConfig(num_experts=4, top_k=2))])
def test_unported_layers_raise(over):
    """Windows, soft caps and MoE blocks are ported (tests/test_torch_window.py,
    tests/test_torch_moe.py); what is left unported in each of those stacks
    is a bidirectional decoder."""
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True), **over)
    Transformer(cfg, device="cpu")
    cfg = dataclasses.replace(cfg, causal=False)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        Transformer(cfg, device="cpu")
    base = Transformer(get_config("glm4_9b", smoke=True), device="cpu")
    for call in (lambda: transformer.apply(cfg, base, torch.zeros(1, 2, dtype=torch.long)),
                 lambda: transformer.init_cache(cfg, 1, 4, "cpu"),
                 lambda: transformer.cache_specs(cfg, 1, 4)):
        with pytest.raises(NotImplementedError, match="bidirectional"):
            call()


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_params_and_init(arch):
    """The parameter count of the full config is the reference's (9.40 B for
    glm4_9b); the cache layout is the reference's; `init` gives the
    reference's scales."""
    full_cfg = get_config(arch)
    assert full_cfg.param_count() == ref_registry.param_count(ref_get_config(arch))
    rcfg, cfg = _cfgs(arch)
    specs, want = transformer.cache_specs(cfg, 3, 16), ref_registry.cache_specs(rcfg, 3, 16)
    assert {n: s for n, (s, _) in specs["full"].items()} == \
        {n: s.shape for n, s in want["full"].items()} and set(specs) == set(want)
    model = registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert isinstance(model, Transformer)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "q_norm", "k_norm"):
            assert bool((p == 1).all()), name
        elif p.ndim == 1:
            assert not p.any(), name
        else:
            want_std = 0.02 if "embed" in leaf else p.shape[-2] ** -0.5
            assert abs(float(p.std()) / want_std - 1) < 0.1, name
    state = params_from_jax(jax.tree.map(np.asarray, ref_registry.init_params(
        rcfg, jax.random.PRNGKey(0))), cfg)
    assert set(state) == set(model.state_dict())
    assert ("lm_head" in state) == (not cfg.tie_embeddings)


def test_transformer_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(get_config("glm4_9b", smoke=True))

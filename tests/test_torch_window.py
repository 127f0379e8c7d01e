"""Sliding-window and local:global decoders and the dense mode's window,
ring and soft cap, held to the reference on the CPU.

  * The dense mode's plain version (`dense_attention_plain`, the test oracle
    of the kernel) with a window, with causality off over a key count (the
    ring cache's prefix validity) and with a soft cap (PWL and exact tanh)
    against `common.attention_scores`; a 2100-query windowed prefill
    against the reference's `attention_auto`, which takes it through
    `chunked_attention` (1024-query chunks over sliced key bands).
    Tolerance: one bf16 ulp of the reference's output plus 2^-7 of
    sum_j p_j |v_j| (sums in another order can round a probability to the
    neighbouring bf16 value), as in tests/test_torch_dense_attention.py.
  * starcoder2_3b (sliding window, LayerNorm with bias, plain GELU MLP with
    bias) and gemma3_27b (local:global, qk-norm, gated GELU, tied head) at
    smoke size (2 layers, window 32, gemma3's layer 1 global): `apply` over
    40 tokens, and, with the window cut to 8, a token-by-token prefill of 9
    tokens plus 3 steps, across the ring's wrap, against the reference in
    float, NPE-8 and NPE-16, with the gates of tests/_torch_decoders.py;
    gemma3 in float over 44 positions of its 32-row ring (max_seq 48).
  * `Server`'s token-by-token ring prefill against the reference server's
    `prefill_prompt`, slot for slot, cache group for cache group.
  * A soft cap set through `shrink(cfg, logit_softcap=...)` (no config in
    either package sets one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_decoders as td
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.launch.serve import Server as RefServer
from repro.models import common as ref_cm
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import dense_attention, dense_attention_plain
from repro_torch.launch import serve as port_serve
from repro_torch.launch.serve import Server
from repro_torch.models import registry, transformer
from repro_torch.models.convert import cache_to_numpy, params_from_jax

torch.set_float32_matmul_precision("highest")

ARCHS = ["starcoder2_3b", "gemma3_27b"]


# --- the dense mode's plain version -----------------------------------------

# (b, hq, hkv, sq, kv_len, rows, d, causal, window, softcap)
MASK_CASES = [
    (2, 4, 2, 40, 40, 40, 32, True, 8, 0.0),        # windowed prefill
    (1, 4, 4, 300, 300, 320, 64, True, 100, 0.0),   # windowed prefill, one kv head a q head
    (2, 4, 2, 1, 700, 768, 32, True, 64, 0.0),      # windowed decode over a long cache
    (2, 4, 2, 1, 20, 32, 32, False, 0, 0.0),        # a ring before its wrap
    (2, 4, 2, 1, 32, 32, 32, False, 0, 0.0),        # a ring past it: every row valid
    (2, 4, 2, 6, 60, 64, 32, True, 0, 50.0),        # soft-capped prefill over a cache
    (1, 4, 2, 24, 24, 24, 32, True, 8, 2.0),        # windowed, a tight cap
]


def _inputs(case, seed=0):
    b, hq, hkv, sq, kv_len, rows, d = case[:7]
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q = 3 * rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = bf(rng.standard_normal((b, rows, hkv, d)).astype(np.float32))
    v = bf(rng.standard_normal((b, rows, hkv, d)).astype(np.float32))
    return q, k, v


def _plain(q, k, v, out_dtype=torch.bfloat16, fn=dense_attention_plain, **kw):
    qt = torch.from_numpy(q).permute(0, 2, 1, 3)
    kt, vt = (torch.from_numpy(a).to(torch.bfloat16).permute(0, 2, 1, 3) for a in (k, v))
    return fn(qt, kt, vt, out_dtype=out_dtype, **kw).permute(0, 2, 1, 3)


def _ref_cfg(use_pwl, softcap):
    cfg = dataclasses.replace(ref_get_config("bert_base", smoke=True), logit_softcap=softcap)
    return cfg.with_npe(8) if use_pwl else cfg


def _close(got, want, spread):
    err = np.abs(got.float().numpy() - want)
    assert bool((err <= td.bf16_ulp(want) + 2.0 ** -7 * spread).all()), float(err.max())


@pytest.mark.parametrize("case", MASK_CASES)
@pytest.mark.parametrize("use_pwl", [True, False])
def test_dense_plain_window_ring_softcap(case, use_pwl):
    """Against `attention_scores`: a windowed cache case (q_offset), or a
    ring (causal off, kv_valid = arange(rows) < kv_len over all the rows)."""
    b, hq, hkv, sq, kv_len, rows, d, causal, window, softcap = case
    q, k, v = _inputs(case)
    cfg = _ref_cfg(use_pwl, softcap)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    if causal:
        want = ref_cm.attention_scores(cfg, jnp.asarray(q), kj[:, :kv_len], vj[:, :kv_len],
                                       window=window, q_offset=kv_len - sq)
    else:
        want = ref_cm.attention_scores(cfg, jnp.asarray(q), kj, vj, causal=False,
                                       kv_valid=jnp.arange(rows) < kv_len)
    want = np.asarray(want.astype(jnp.float32))
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap, use_pwl=use_pwl)
    got = _plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, _plain(q, k, np.abs(v), torch.float32, **kw).numpy())
    assert torch.equal(_plain(q, k, v, fn=dense_attention, **kw), got)   # the CPU route


@pytest.mark.parametrize("use_pwl", [True, False])
def test_long_windowed_prefill_matches_chunked_attention(use_pwl):
    """2100 queries (> 2048): the reference's `attention_auto` runs
    `chunked_attention` (chunks of 1024 queries over key bands of window +
    1024); the dense mode gives the same function in one pass."""
    case = (1, 2, 1, 2100, 2100, 2100, 32, True, 64, 0.0)
    q, k, v = _inputs(case, seed=1)
    cfg = _ref_cfg(use_pwl, 0.0)
    want = ref_cm.attention_auto(cfg, jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), window=64)
    want = np.asarray(want.astype(jnp.float32))
    kw = dict(kv_len=2100, window=64, use_pwl=use_pwl)
    _close(_plain(q, k, v, **kw), want, _plain(q, k, np.abs(v), torch.float32, **kw).numpy())


def test_dense_wrapper_refuses_bad_window_and_cap():
    q = torch.zeros(1, 4, 3, 32)
    k = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dense_attention(q, k, k, window=-1)
    with pytest.raises(ValueError):
        dense_attention(q, k, k, softcap=-1.0)


# --- the decoders ---------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return (request.param, *td.load(request.param))


@pytest.mark.parametrize("mode", list(td.MODES))
def test_apply_matches_reference(weights, mode):
    arch, params, model = weights
    rcfg, cfg = td.cfgs(arch, mode)
    tok = td.tokens(40)                 # past the 32-key window
    want = td.ref_apply(rcfg, params, tok)
    noise = float(np.abs(td.ref_apply(rcfg, td.nudge(params), tok) - want).max())
    got = td.port_apply(cfg, model, tok)
    assert got.shape == want.shape == (2, 40, 512)
    diff = np.abs(got - want)
    assert td.gate(mode, diff, noise), (arch, mode, float(diff.max()), noise)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", list(td.MODES))
def test_decode_matches_reference(weights, mode):
    """The window cut to 8 (max_seq 16): a token-by-token prefill of 9
    tokens, past the ring's wrap, then 3 greedy steps: logits, tokens and
    both cache groups."""
    arch, params, model = weights
    cache = td.check_decode(arch, mode, params, model, td.tokens(9, seed=1), 3, 16, window=8)
    windows = transformer.layer_windows(get_config(arch, smoke=True))
    assert set(cache) == ({"win"} if windows.all() else {"full", "win"})
    assert cache["win"]["k"].shape == (int((windows > 0).sum()), 2, 8, 2, 32)


def test_layer_windows_and_cache_groups():
    """gemma3: 5 local layers of window 1024, then a global one; the ring
    holds min(window, max_seq) rows, as the reference's cache_specs."""
    from repro.models import registry as ref_registry
    from repro.models import transformer as ref_tf
    for arch in ARCHS + ["glm4_9b", "granite_moe_1b_a400m"]:
        for smoke in (False, True):
            cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
            assert np.array_equal(transformer.layer_windows(cfg), ref_tf.layer_windows(rcfg))
            for max_seq in (16, 2048):
                got = transformer.cache_specs(cfg, 3, max_seq)
                want = ref_registry.cache_specs(rcfg, 3, max_seq)
                assert list(got) == list(want)
                assert {g: {n: s for n, (s, _) in kv.items()} for g, kv in got.items()} == \
                    {g: {n: s.shape for n, s in kv.items()} for g, kv in want.items()}
    w = transformer.layer_windows(get_config("gemma3_27b"))
    assert w.tolist()[:12] == [1024] * 5 + [0] + [1024] * 5 + [0] and len(w) == 62


def test_multi_token_call_on_a_ring_raises():
    cfg = get_config("gemma3_27b", smoke=True)
    model = registry.build_model(cfg, device="cpu")
    cache = registry.init_cache(cfg, 1, 16, "cpu")
    with pytest.raises(ValueError, match="one at a time"):
        registry.decode_step(cfg, model, cache, torch.zeros(1, 3, dtype=torch.long), 0)


def test_ring_decode_across_the_wrap():
    """gemma3 at the smoke window, 41 prompt tokens one a call, then 3
    steps: 44 positions over a 32-row ring (max_seq 48), in float (44
    op-by-op NPE steps would take half a minute; the decoder tests above
    wrap an 8-row ring in every mode)."""
    params, model = td.load("gemma3_27b")
    cache = td.check_decode("gemma3_27b", "float", params, model, td.tokens(41, seed=3), 3, 48)
    assert cache["win"]["k"].shape[2] == 32


@pytest.fixture
def float32_servers(monkeypatch):
    """Both servers build their configs in float32."""
    for mod in (ref_serve, port_serve):
        build_cfg = mod.get_config
        monkeypatch.setattr(mod, "get_config", lambda arch, smoke, b=build_cfg: (
            dataclasses.replace(b(arch, smoke=smoke), dtype="float32")))


def test_server_ring_prefill_matches_reference(float32_servers):
    """gemma3 smoke in float32: `Server.prefill_prompt` of 3 slots with
    prompts of 5, 9 and 40 tokens (the last past the 32-row ring), token by
    token, against the reference server's, slot for slot; then 4 served
    greedy tokens equal."""
    ref = RefServer("gemma3_27b", smoke=True, batch=3, max_seq=48)
    cfg = dataclasses.replace(get_config("gemma3_27b", smoke=True), dtype="float32")
    model = registry.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ref.params), cfg))
    srv = Server("gemma3_27b", batch=3, max_seq=48, mode="float", device="cpu",
                 model=model, smoke=True)
    assert srv.cfg.dtype == "float32"
    prompts = [td.tokens(n, seed=n, batch=1)[0] for n in (5, 9, 40)]
    for slot, p in enumerate(prompts):
        ref.prefill_prompt(slot, p)
        srv.prefill_prompt(slot, p)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), ref.cache)
    got = cache_to_numpy(srv.cache)
    assert list(got) == list(want) == ["full", "win"]
    for group in want:
        for name in ("k", "v"):
            w, g = want[group][name], got[group][name]
            assert g.shape == w.shape
            # a bf16 ulp past a float32 difference of F32_FLOOR (XLA's
            # compiled products against the eager ones)
            assert bool((np.abs(g - w) <= td.bf16_ulp(w) + td.F32_FLOOR).all()), (group, name)
    out = []
    step = ref.decode
    ref.decode = lambda *a: (lambda r: (out.append(np.asarray(r[0])[:, 0]), r)[1])(step(*a))
    ref.cache = jax.tree.map(jnp.zeros_like, ref.cache)
    ref.generate(prompts, gen_tokens=4)
    srv.cache = registry.init_cache(srv.cfg, 3, 48, "cpu")
    stats = srv.generate(prompts, gen_tokens=4)
    assert np.array_equal(stats.generated, np.stack(out, 1))


@pytest.mark.parametrize("mode", ["float", "npe8"])
def test_logit_softcap_through_shrink(mode):
    """gemma3 smoke with `logit_softcap=2` (tight, so the cap bites):
    `apply` and the decoder tests' prefill and steps against the reference."""
    params, model = td.load("gemma3_27b", logit_softcap=2.0)
    rcfg, cfg = td.cfgs("gemma3_27b", mode, logit_softcap=2.0)
    assert cfg.logit_softcap == rcfg.logit_softcap == 2.0
    tok = td.tokens(40, seed=4)
    want = td.ref_apply(rcfg, params, tok)
    noise = float(np.abs(td.ref_apply(rcfg, td.nudge(params), tok) - want).max())
    diff = np.abs(td.port_apply(cfg, model, tok) - want)
    assert td.gate(mode, diff, noise), (mode, float(diff.max()), noise)
    td.check_decode("gemma3_27b", mode, params, model, td.tokens(9, seed=5), 3, 16,
                    window=8, logit_softcap=2.0)

"""Shared helpers of the decoder tests that hold the port's transformer
(`repro_torch.models`) to the reference's (`repro.models.registry`) on the
same weights: the reference's float32 `init_params` of a smoke config,
handed to the port through `params_from_jax`; the reference run under
`jax.disable_jit()`, op by op, as the port runs (compiled, XLA's fused
roundings move NPE-8 logits by more than the gate: tests/test_torch_transformer.py).

Gates, as in tests/test_torch_transformer.py:
  * float: within FACTOR times the reference's own change under a 1-ulp
    weight nudge; in decode, or within BF16_FLIP if that is larger: the
    probabilities and the cache are rounded to bf16 there, and a float32
    difference in the last place can round one of them to the neighbouring
    bf16 value, 2^-8 of it away, which moves the smoke logits (up to about
    4) by about 2e-5 (1.6e-5 measured on llama4's prefill), while one
    nudge of the reference need not flip any;
  * NPE-8 and NPE-16: within NPE_TOL (the reference's NPE gate) on every
    logit;
  * NPE-16 decode: at least NPE16_BULK of the logits within NPE_TOL and
    every one within FACTOR times the nudge change (its float32 product
    on the int16 grid sums in another order than XLA's, and an ulp there
    moves a bf16 cache entry now and then, as it moves the reference's own
    compiled run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro_torch.configs import get_config, shrink
from repro_torch.models import registry
from repro_torch.models.convert import cache_to_numpy, params_from_jax

MODES = {"float": lambda c: c, "npe8": lambda c: c.with_npe(8),
         "npe16": lambda c: c.with_npe(16)}
NPE_TOL, FACTOR, NPE16_BULK = 5e-3, 2.0, 0.99
F32_FLOOR = 1e-6
BF16_FLIP = 1e-4
VOCAB = 512


def cfgs(arch, mode="float", **over):
    """(reference config, port config): the smoke config in float32 with
    `over` applied through each package's `shrink`, in `mode`."""
    over = dict(over, dtype="float32")
    return (MODES[mode](ref_shrink(ref_get_config(arch), **over)),
            MODES[mode](shrink(get_config(arch), **over)))


def load(arch, seed=0, **over):
    """(the reference's float32 params as numpy, the port's model on them)."""
    rcfg, cfg = cfgs(arch, **over)
    params = jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(seed)))
    model = registry.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return params, model


def nudge(tree):
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


def tokens(n, seed=0, batch=2):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, n)).astype(np.int32)


def gate(mode, diff, noise, decode=False):
    """Whether |port - reference| of every logit, `diff`, passes."""
    if mode == "float":
        return diff.max() <= max(FACTOR * noise, BF16_FLIP if decode else 0.0)
    if mode == "npe16" and decode:
        return diff.max() <= FACTOR * noise and (diff <= NPE_TOL).mean() >= NPE16_BULK
    return diff.max() <= NPE_TOL


def ref_apply(rcfg, params, tok):
    with jax.disable_jit():
        return np.asarray(ref_registry.apply(rcfg, params, jnp.asarray(tok), remat=False))


def port_apply(cfg, model, tok):
    return registry.apply(cfg, model, torch.from_numpy(tok).long()).numpy()


def ref_decode(rcfg, params, tok, steps, max_seq, feed=None):
    """(logits of the prefill and of each step, greedy tokens (B, steps),
    cache as float32 numpy) of the reference: the prompt in one multi-token
    `decode_step` at 0 (token by token at 0..S-1 with window rings, as its
    server prefills them), then `steps` single-token steps; steps after the
    first take `feed` where given."""
    cache = ref_cm.init_params(ref_registry.cache_specs(rcfg, tok.shape[0], max_seq),
                               jax.random.PRNGKey(0))
    n = tok.shape[1]
    calls = [(tok[:, t:t + 1], t) for t in range(n)] if "win" in cache else [(tok, 0)]
    logits, toks = [], []
    with jax.disable_jit():
        for t, at in calls:
            lg, cache = ref_registry.decode_step(rcfg, params, cache, jnp.asarray(t), jnp.int32(at))
            logits.append(np.asarray(lg))
        cur = tok[:, -1:]
        for i in range(steps):
            lg, cache = ref_registry.decode_step(rcfg, params, cache, jnp.asarray(cur),
                                                 jnp.int32(n + i))
            logits.append(np.asarray(lg))
            toks.append(logits[-1][:, -1].argmax(-1))
            cur = (toks[-1] if feed is None else feed[:, i])[:, None].astype(np.int32)
    toks = np.stack(toks, 1) if toks else None
    return logits, toks, jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def port_decode(cfg, model, tok, steps, max_seq, feed):
    """The port's counterpart of `ref_decode`, fed `feed` after the first step."""
    cache = registry.init_cache(cfg, tok.shape[0], max_seq, "cpu")
    n = tok.shape[1]
    calls = [(tok[:, t:t + 1], t) for t in range(n)] if "win" in cache else [(tok, 0)]
    logits, toks = [], []
    for t, at in calls:
        lg, cache = registry.decode_step(cfg, model, cache, torch.from_numpy(t).long(), at)
        logits.append(lg.numpy())
    cur = torch.from_numpy(tok[:, -1:]).long()
    for i in range(steps):
        lg, cache = registry.decode_step(cfg, model, cache, cur, n + i)
        logits.append(lg.numpy())
        toks.append(logits[-1][:, -1].argmax(-1))
        cur = torch.from_numpy(feed[:, i:i + 1]).long()
    return logits, np.stack(toks, 1) if toks else None, cache_to_numpy(cache)


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


def check_decode(arch, mode, params, model, tok, steps, max_seq, **over):
    """Prefill and `steps` steps of the port against the reference (fed the
    reference's greedy tokens): logits by `gate`, the same greedy tokens,
    every cache group within FACTOR times the nudged reference's change or
    one bf16 ulp past a float32 difference of F32_FLOOR (a k or v entry is
    a float32 sum of unit-scale products, rounded to bf16; summed in
    another order it moves by about 1e-7, which crosses the bf16 rounding
    of a value near 1e-5 by two of its ulps)."""
    rcfg, cfg = cfgs(arch, mode, **over)
    want_lg, want_tok, want_cache = ref_decode(rcfg, params, tok, steps, max_seq)
    nud_lg, _, nud_cache = ref_decode(rcfg, nudge(params), tok, steps, max_seq, want_tok)
    got_lg, got_tok, got_cache = port_decode(cfg, model, tok, steps, max_seq, want_tok)
    assert [g.shape for g in got_lg] == [w.shape for w in want_lg]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got_lg, want_lg)])
    noise = max(float(np.abs(n - w).max()) for n, w in zip(nud_lg, want_lg))
    assert gate(mode, diff, noise, decode=True), (
        arch, mode, float(diff.max()), float((diff <= NPE_TOL).mean()), noise)
    assert np.array_equal(got_tok, want_tok)
    assert set(got_cache) == set(want_cache)
    for group in want_cache:
        for name in ("k", "v"):
            g, w = got_cache[group][name], want_cache[group][name]
            assert g.shape == w.shape, (group, g.shape, w.shape)
            n = FACTOR * float(np.abs(nud_cache[group][name] - w).max())
            assert bool((np.abs(g - w) <= np.maximum(bf16_ulp(w) + F32_FLOOR, n)).all()), (
                group, name)
    return got_cache


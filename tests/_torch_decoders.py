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


def load(arch, seed=0, jitter=0.0, **over):
    """(the reference's float32 params as numpy, the port's model on them).
    `jitter` > 0 adds seeded normal noise of that scale to every weight, so
    that the reference's zero and one initialisers (biases, LoRA-b, decay
    offsets, SSM skips) take values that a test can see."""
    rcfg, cfg = cfgs(arch, **over)
    params = jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(seed)))
    if jitter:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda a: (a + jitter * rng.standard_normal(a.shape)).astype(np.float32), params)
    model = registry.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return params, model


def nudge(tree, to=np.inf):
    """Every weight moved by one ulp up (or, to=-np.inf, down)."""
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(to)), tree)


def tokens(n, seed=0, batch=2):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, n)).astype(np.int32)


def gate(mode, diff, noise, decode=False, npe8_noise=False, noise_bulk=None):
    """Whether |port - reference| of every logit, `diff`, passes.
    `npe8_noise`: NPE-8 may also pass within FACTOR times the nudged
    reference's change (a 1-ulp weight can move an activation across an
    int8 step there, and the logits with it).  `noise_bulk`: the share of
    the nudged reference's logits within NPE_TOL of its own; NPE-16 decode
    may then leave out FACTOR times the share that the nudge leaves out,
    where that is more than 1 - NPE16_BULK."""
    if mode == "npe8" and npe8_noise and diff.max() <= FACTOR * noise:
        return True
    if mode == "float":
        return diff.max() <= max(FACTOR * noise, BF16_FLIP if decode else 0.0)
    if mode == "npe16" and decode:
        bulk = NPE16_BULK if noise_bulk is None else min(NPE16_BULK,
                                                         1 - FACTOR * (1 - noise_bulk))
        return diff.max() <= FACTOR * noise and (diff <= NPE_TOL).mean() >= bulk
    return diff.max() <= NPE_TOL


def ref_apply(rcfg, params, tok):
    with jax.disable_jit():
        return np.asarray(ref_registry.apply(rcfg, params, jnp.asarray(tok), remat=False))


def port_apply(cfg, model, tok):
    return registry.apply(cfg, model, torch.from_numpy(tok).long()).numpy()


def prefill_calls(cache, tok):
    """The prefill's (tokens, pos) calls, as the reference's server makes
    them: the prompt in one multi-token call at 0 where the cache is a
    `full` KV group alone, else token by token at 0..S-1."""
    if set(cache) == {"full"}:
        return [(tok, 0)]
    return [(tok[:, t:t + 1], t) for t in range(tok.shape[1])]


def ref_cross_cache(rcfg, params, frames):
    from repro.models import encdec
    with jax.disable_jit():
        return encdec.init_cross_cache(rcfg, params, jnp.asarray(frames))


def ref_decode(rcfg, params, tok, steps, max_seq, feed=None, frames=None):
    """(logits of the prefill and of each step, greedy tokens (B, steps),
    cache as float32 numpy) of the reference: the prompt by
    `prefill_calls`, then `steps` single-token steps; steps after the first
    take `feed` where given.  `frames`: an encoder-decoder's frame
    embeddings, whose cross cache fills the cache first."""
    cache = ref_cm.init_params(ref_registry.cache_specs(rcfg, tok.shape[0], max_seq),
                               jax.random.PRNGKey(0))
    if frames is not None:
        cache["cross"] = ref_cross_cache(rcfg, params, frames)
    n = tok.shape[1]
    calls = prefill_calls(cache, tok)
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


def port_decode(cfg, model, tok, steps, max_seq, feed, frames=None):
    """The port's counterpart of `ref_decode`, fed `feed` after the first step."""
    cache = registry.init_cache(cfg, tok.shape[0], max_seq, "cpu")
    if frames is not None:
        from repro_torch.models import encdec
        cache["cross"] = encdec.init_cross_cache(cfg, model, torch.from_numpy(frames))
    n = tok.shape[1]
    calls = prefill_calls(cache, tok)
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


def leaves(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def check_decode(arch, mode, params, model, tok, steps, max_seq, frames=None,
                 npe8_noise=False, both_ways=False, **over):
    """Prefill and `steps` steps of the port against the reference (fed the
    reference's greedy tokens): logits by `gate`, the same greedy tokens,
    every cache tensor (KV groups and recurrent states) within FACTOR times
    the nudged reference's change or one bf16 ulp past a float32 difference
    of F32_FLOOR (a k or v entry is a float32 sum of unit-scale products,
    rounded to bf16; summed in another order it moves by about 1e-7, which
    crosses the bf16 rounding of a value near 1e-5 by two of its ulps).
    `npe8_noise`: as for `gate`.  `both_ways`: the reference is nudged one
    ulp up and one ulp down, and its larger change (and, for NPE-16, the
    smaller share of logits within NPE_TOL, `gate`'s `noise_bulk`) is the
    gate's: a nudge up need not round a bf16 probability or cache entry the
    other way where a nudge down does."""
    rcfg, cfg = cfgs(arch, mode, **over)
    want_lg, want_tok, want_cache = ref_decode(rcfg, params, tok, steps, max_seq, frames=frames)
    nudged = [ref_decode(rcfg, nudge(params, to), tok, steps, max_seq, want_tok, frames=frames)
              for to in ((np.inf, -np.inf) if both_ways else (np.inf,))]
    got_lg, got_tok, got_cache = port_decode(cfg, model, tok, steps, max_seq, want_tok,
                                             frames=frames)
    assert [g.shape for g in got_lg] == [w.shape for w in want_lg]
    cat = lambda a: np.concatenate([np.abs(x - w).ravel() for x, w in zip(a, want_lg)])  # noqa: E731
    diff = cat(got_lg)
    noise = max(float(cat(nud_lg).max()) for nud_lg, _, _ in nudged)
    noise_bulk = (min(float((cat(nud_lg) <= NPE_TOL).mean()) for nud_lg, _, _ in nudged)
                  if both_ways else None)
    assert gate(mode, diff, noise, decode=True, npe8_noise=npe8_noise, noise_bulk=noise_bulk), (
        arch, mode, float(diff.max()), float((diff <= NPE_TOL).mean()), noise, noise_bulk)
    assert np.array_equal(got_tok, want_tok)
    got, want = leaves(got_cache), leaves(want_cache)
    nuds = [leaves(nud_cache) for _, _, nud_cache in nudged]
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (path, g.shape, w.shape)
        n = FACTOR * max(float(np.abs(nud[path] - w).max()) for nud in nuds)
        assert bool((np.abs(g - w) <= np.maximum(bf16_ulp(w) + F32_FLOOR, n)).all()), (
            path, float(np.abs(g - w).max()), n)
    return got_cache


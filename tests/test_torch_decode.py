"""The port's KV-cache decode path (`bert.decode_step`) against the
reference's (`repro.models.registry.decode_step`), on the smoke config
(2 layers, D=128, 4 q-heads over 2 kv-heads), float32 weights through
`params_from_jax`, bf16 caches, the reference's own serving flow: two
ragged prompts (5 and 12 tokens), each prefilled alone on its slot's cache
slice at position 0, then 8 single-token steps for both slots on one common
position clock.  Both sides are fed the same tokens (the reference's greedy
ones), so the steps compare like with like.

The port's attention is the flash kernel, whose P.V product takes the
probabilities in float32, as the reference's own flash kernel does; the
reference's decode path (`attention_scores`) rounds them to bf16 first
(`probs.astype(v.dtype)`).  That is the one arithmetic difference by
design, and the tests measure it on the reference itself: `F32_PROBS` runs
the reference with its probabilities kept in float32 (v handed over as
float32, the result cast back to bf16), which within one KV block is what
its flash kernel computes.  Rules:

  * caches: the first layer's (before any attention) within one bf16 ulp of
    the reference; every layer's within one bf16 ulp of the float32-
    probability reference, or within twice that reference's own change under
    a 1-ulp weight nudge (NPE-16: a float rounding can move a value across
    an int16 step);
  * logits: within twice the larger of the reference's own change under a
    1-ulp weight nudge and its change when its probabilities stay float32;
  * greedy tokens identical (float, NPE-16); NPE-8 top-1 agreement no lower
    than the nudged reference's, less 0.02 (tests/test_torch_bert.py).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro_torch.configs import get_config
from repro_torch.models import bert, registry
from repro_torch.models.bert import Bert
from repro_torch.models.convert import cache_from_jax, cache_to_numpy, params_from_jax

torch.set_float32_matmul_precision("highest")

BATCH, MAX_SEQ, STEPS = 2, 32, 8
PROMPT_LENS = (5, 12)
FACTOR = 2.0
TOP1_MARGIN = 0.02
MODES = {"float": lambda c: c, "npe16": lambda c: c.with_npe(16),
         "npe8": lambda c: c.with_npe(8)}


def _cfgs(mode):
    over = dict(dtype="float32")
    return (MODES[mode](dataclasses.replace(ref_get_config("bert_base", smoke=True), **over)),
            MODES[mode](dataclasses.replace(get_config("bert_base", smoke=True), **over)))


def _prompts():
    rng = np.random.default_rng(10)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def ref_params():
    rcfg, _ = _cfgs("float")
    return jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(0)))


def _nudge(tree):
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


@contextlib.contextmanager
def F32_PROBS():
    """The reference's decode with float32 probabilities in P.V."""
    dense = ref_cm.attention_scores

    def f32_probs(cfg, q, k, v, **kw):
        return dense(cfg, q, k, v.astype(jnp.float32), **kw).astype(v.dtype)

    ref_cm.attention_scores = f32_probs
    try:
        yield
    finally:
        ref_cm.attention_scores = dense


def _run_ref(rcfg, params, feed=None):
    """(prefill logits per slot, cache after prefill, step logits, greedy
    tokens (B, STEPS), final cache); steps after the first are fed `feed`
    where given, else the greedy tokens."""
    step = jax.jit(lambda p, c, t, pos: ref_registry.decode_step(rcfg, p, c, t, pos))
    cache = ref_cm.init_params(ref_registry.cache_specs(rcfg, BATCH, MAX_SEQ),
                               jax.random.PRNGKey(0))
    prefill = []
    for slot, p in enumerate(_prompts()):
        sub = jax.tree.map(lambda a: a[:, slot:slot + 1], cache)
        lg, sub = step(params, sub, jnp.asarray(p)[None], jnp.int32(0))
        cache = jax.tree.map(lambda f, s: f.at[:, slot:slot + 1].set(s), cache, sub)
        prefill.append(np.asarray(lg))
    pre_cache = jax.tree.map(np.asarray, cache)
    start = max(PROMPT_LENS)
    cur = np.array([[p[-1]] for p in _prompts()], np.int32)
    steps, toks = [], []
    for i in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(cur), jnp.int32(start + i))
        steps.append(np.asarray(lg))
        toks.append(steps[-1][:, -1].argmax(-1))
        cur = (toks[-1] if feed is None else feed[:, i])[:, None].astype(np.int32)
    return prefill, pre_cache, steps, np.stack(toks, 1), jax.tree.map(np.asarray, cache)


def _run_port(cfg, params, feed):
    model = Bert(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    cache = registry.init_cache(cfg, BATCH, MAX_SEQ, "cpu")
    prefill = []
    for slot, p in enumerate(_prompts()):
        sub = {"full": {k: c[:, slot:slot + 1] for k, c in cache["full"].items()}}
        lg, _ = bert.decode_step(cfg, model, sub, torch.from_numpy(p).long()[None], 0)
        prefill.append(lg.numpy())
    pre_cache = cache_to_numpy(cache)
    start = max(PROMPT_LENS)
    cur = torch.tensor([[int(p[-1])] for p in _prompts()])
    steps, toks = [], []
    for i in range(STEPS):
        lg, cache = registry.decode_step(cfg, model, cache, cur, start + i)
        steps.append(lg.numpy())
        toks.append(steps[-1][:, -1].argmax(-1))
        cur = torch.from_numpy(feed[:, i]).long()[:, None]
    return prefill, pre_cache, steps, np.stack(toks, 1), cache_to_numpy(cache)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, ref_params):
    rcfg, cfg = _cfgs(request.param)
    want = _run_ref(rcfg, ref_params)
    feed = want[3]
    nudged = _run_ref(rcfg, _nudge(ref_params), feed)
    with F32_PROBS():
        want32 = _run_ref(rcfg, ref_params, feed)
        nudged32 = _run_ref(rcfg, _nudge(ref_params), feed)
    return request.param, want, nudged, want32, nudged32, _run_port(cfg, ref_params, feed)


@pytest.mark.parametrize("which", [1, 4])          # after the prefills, at the end
def test_caches(runs, which):
    _, want, _, want32, nudged32, got = runs
    for name in ("k", "v"):
        g = got[which]["full"][name]
        w = np.asarray(want[which]["full"][name], np.float32)
        assert g.shape == w.shape == (2, BATCH, MAX_SEQ, 2, 32)
        assert bool((np.abs(g[0] - w[0]) <= _bf16_ulp(w[0])).all())
        w32 = np.asarray(want32[which]["full"][name], np.float32)
        noise = FACTOR * float(np.abs(np.asarray(nudged32[which]["full"][name], np.float32)
                                      - w32).max())
        assert bool((np.abs(g - w32) <= np.maximum(_bf16_ulp(w32), noise)).all())
        # rows past each slot's prompt and the steps are untouched
        assert not g[:, :, max(PROMPT_LENS) + STEPS:].any()


def test_logits(runs):
    mode, want, nudged, want32, _, got = runs
    for part in (0, 2):                              # prefill logits, step logits
        tol = FACTOR * max(_max_diff(nudged[part], want[part]),
                           _max_diff(want32[part], want[part]))
        assert _max_diff(got[part], want[part]) <= tol, (mode, part)
    assert got[0][0].shape == (1, 5, 512) and got[2][0].shape == (BATCH, 1, 512)


def test_greedy_tokens(runs):
    mode, want, nudged, _, _, got = runs
    if mode == "npe8":
        agree_nudge = float((nudged[3] == want[3]).mean())
        assert float((got[3] == want[3]).mean()) >= agree_nudge - TOP1_MARGIN
    else:
        assert np.array_equal(got[3], want[3])


def test_cache_round_trip_and_specs():
    _, cfg = _cfgs("float")
    rcfg, _ = _cfgs("float")
    specs = bert.cache_specs(cfg, 3, 16)
    ref_specs = ref_registry.cache_specs(rcfg, 3, 16)
    for name in ("k", "v"):
        shape, dtype = specs["full"][name]
        assert shape == ref_specs["full"][name].shape and dtype == torch.bfloat16
    tree = {"full": {n: np.asarray(jax.random.normal(jax.random.PRNGKey(i), shape)
                                   .astype(jnp.bfloat16)) for i, n in enumerate("kv")}}
    cache = cache_from_jax(tree)
    assert cache["full"]["k"].dtype == torch.bfloat16
    back = cache_to_numpy(cache)
    for n in "kv":
        assert np.array_equal(back["full"][n], np.asarray(tree["full"][n], np.float32))


def test_decode_step_refuses_rows_past_the_cache():
    _, cfg = _cfgs("float")
    model = Bert(cfg, device="cpu")
    cache = registry.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError):
        registry.decode_step(cfg, model, cache, torch.zeros(1, 3, dtype=torch.long), 6)


def test_registry_names_only_bert():
    _, cfg = _cfgs("float")
    with pytest.raises(ValueError):
        registry.module_for(dataclasses.replace(cfg, family="dense"))
    assert registry.module_for(cfg) is bert

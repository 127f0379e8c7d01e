"""The port's KV-cache decode path (`bert.decode_step`) against the
reference's (`repro.models.registry.decode_step`), on the smoke config
(2 layers, D=128, 4 q-heads over 2 kv-heads), float32 weights through
`params_from_jax`, bf16 caches, the reference's own serving flow: ragged
prompts, each prefilled alone on its slot's cache slice at position 0, then
single-token steps for every slot on one common position clock.  Both sides
are fed the same tokens (the reference's greedy ones), so the steps compare
like with like.

Two serving runs: SHORT (two prompts of 5 and 12 tokens, 8 steps, a 32-row
cache) and LONG (prompts of 300 and 17 tokens, 4 steps, a 320-row cache,
max_position raised to 512 on both packages' configs), whose positions cross
256: one softmax over every visible key, with no KV blocking, is what the
reference's `attention_scores` computes at any cache length.

The port's attention is the flash kernel's dense mode (its plain version on
the CPU), the reference's arithmetic: the probabilities rounded to the
cache's bf16 before P.V.  Rules:

  * caches: in SHORT the first layer's (before any attention) within one
    bf16 ulp of the reference; every layer's within one bf16 ulp of the reference, or
    within twice the reference's own change under a 1-ulp weight nudge
    (NPE-16: a float rounding can move a value across an int16 step);
  * logits: within twice the reference's own change under a 1-ulp weight
    nudge;
  * greedy tokens identical (float, NPE-16); NPE-8 top-1 agreement no lower
    than the nudged reference's, less 0.02 (tests/test_torch_bert.py).
"""
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

@dataclasses.dataclass(frozen=True)
class Serving:
    prompt_lens: tuple
    max_seq: int
    steps: int
    max_position: int = 0          # 0: the smoke config's

    @property
    def batch(self):
        return len(self.prompt_lens)


SHORT = Serving((5, 12), 32, 8)
LONG = Serving((300, 17), 320, 4, max_position=512)
FACTOR = 2.0
TOP1_MARGIN = 0.02
MODES = {"float": lambda c: c, "npe16": lambda c: c.with_npe(16),
         "npe8": lambda c: c.with_npe(8)}


def _cfgs(mode, run=SHORT):
    over = dict(dtype="float32")
    if run.max_position:
        over["max_position"] = run.max_position
    return (MODES[mode](dataclasses.replace(ref_get_config("bert_base", smoke=True), **over)),
            MODES[mode](dataclasses.replace(get_config("bert_base", smoke=True), **over)))


def _prompts(run=SHORT):
    rng = np.random.default_rng(10)
    return [rng.integers(0, 512, n).astype(np.int32) for n in run.prompt_lens]


def _ref_params(max_position):
    """The reference's weights; a larger max_position draws a longer position
    table from the same key."""
    rcfg, _ = _cfgs("float", Serving((1,), 1, 1, max_position))
    return jax.tree.map(np.asarray, ref_registry.init_params(rcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params(0)


def _nudge(tree):
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


def _run_ref(rcfg, params, feed=None, run=SHORT):
    """(prefill logits per slot, cache after prefill, step logits, greedy
    tokens (B, steps), final cache); steps after the first are fed `feed`
    where given, else the greedy tokens."""
    step = jax.jit(lambda p, c, t, pos: ref_registry.decode_step(rcfg, p, c, t, pos))
    cache = ref_cm.init_params(ref_registry.cache_specs(rcfg, run.batch, run.max_seq),
                               jax.random.PRNGKey(0))
    prefill = []
    for slot, p in enumerate(_prompts(run)):
        sub = jax.tree.map(lambda a: a[:, slot:slot + 1], cache)
        lg, sub = step(params, sub, jnp.asarray(p)[None], jnp.int32(0))
        cache = jax.tree.map(lambda f, s: f.at[:, slot:slot + 1].set(s), cache, sub)
        prefill.append(np.asarray(lg))
    pre_cache = jax.tree.map(np.asarray, cache)
    start = max(run.prompt_lens)
    cur = np.array([[p[-1]] for p in _prompts(run)], np.int32)
    steps, toks = [], []
    for i in range(run.steps):
        lg, cache = step(params, cache, jnp.asarray(cur), jnp.int32(start + i))
        steps.append(np.asarray(lg))
        toks.append(steps[-1][:, -1].argmax(-1))
        cur = (toks[-1] if feed is None else feed[:, i])[:, None].astype(np.int32)
    return prefill, pre_cache, steps, np.stack(toks, 1), jax.tree.map(np.asarray, cache)


def _run_port(cfg, params, feed, run=SHORT):
    model = Bert(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    cache = registry.init_cache(cfg, run.batch, run.max_seq, "cpu")
    prefill = []
    for slot, p in enumerate(_prompts(run)):
        sub = {"full": {k: c[:, slot:slot + 1] for k, c in cache["full"].items()}}
        lg, _ = bert.decode_step(cfg, model, sub, torch.from_numpy(p).long()[None], 0)
        prefill.append(lg.numpy())
    pre_cache = cache_to_numpy(cache)
    start = max(run.prompt_lens)
    cur = torch.tensor([[int(p[-1])] for p in _prompts(run)])
    steps, toks = [], []
    for i in range(run.steps):
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


def _serve_both(mode, params, run):
    rcfg, cfg = _cfgs(mode, run)
    want = _run_ref(rcfg, params, run=run)
    feed = want[3]
    nudged = _run_ref(rcfg, _nudge(params), feed, run)
    return mode, run, want, nudged, _run_port(cfg, params, feed, run)


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, ref_params):
    return _serve_both(request.param, ref_params, SHORT)


@pytest.fixture(scope="module", params=list(MODES))
def long_runs(request):
    return _serve_both(request.param, _ref_params(LONG.max_position), LONG)


def _check_caches(runs, which):
    _, run, want, nudged, got = runs
    for name in ("k", "v"):
        g = got[which]["full"][name]
        w = np.asarray(want[which]["full"][name], np.float32)
        assert g.shape == w.shape == (2, run.batch, run.max_seq, 2, 32)
        if run is SHORT:   # before any attention (in LONG, NPE-16 steps cross int16 steps)
            assert bool((np.abs(g[0] - w[0]) <= _bf16_ulp(w[0])).all())
        noise = FACTOR * float(np.abs(np.asarray(nudged[which]["full"][name], np.float32)
                                      - w).max())
        assert bool((np.abs(g - w) <= np.maximum(_bf16_ulp(w), noise)).all()), name
        # rows past each slot's prompt and the steps are untouched
        assert not g[:, :, max(run.prompt_lens) + run.steps:].any()


def _check_logits(runs):
    mode, run, want, nudged, got = runs
    for part in (0, 2):                              # prefill logits, step logits
        tol = FACTOR * _max_diff(nudged[part], want[part])
        assert _max_diff(got[part], want[part]) <= tol, (mode, part)
    assert got[0][0].shape == (1, run.prompt_lens[0], 512)
    assert got[2][0].shape == (run.batch, 1, 512)


def _check_tokens(runs):
    mode, _, want, nudged, got = runs
    if mode == "npe8":
        agree_nudge = float((nudged[3] == want[3]).mean())
        assert float((got[3] == want[3]).mean()) >= agree_nudge - TOP1_MARGIN
    else:
        assert np.array_equal(got[3], want[3])


@pytest.mark.parametrize("which", [1, 4])          # after the prefills, at the end
def test_caches(runs, which):
    _check_caches(runs, which)


def test_logits(runs):
    _check_logits(runs)


def test_greedy_tokens(runs):
    _check_tokens(runs)


@pytest.mark.parametrize("which", [1, 4])
def test_caches_past_256(long_runs, which):
    _check_caches(long_runs, which)


def test_logits_past_256(long_runs):
    _check_logits(long_runs)


def test_greedy_tokens_past_256(long_runs):
    _check_tokens(long_runs)


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
    """BERT's config maps to models/bert, and every other family of the
    reference to its module (the decoders since their port,
    tests/test_torch_transformer.py and tests/test_torch_moe.py; RWKV6, the
    hybrid and the encoder-decoder since theirs, tests/test_torch_rwkv6.py,
    test_torch_hybrid.py, test_torch_encdec.py); an unknown family raises."""
    from repro_torch.models import encdec, hybrid, rwkv6, transformer
    _, cfg = _cfgs("float")
    assert registry.module_for(cfg) is bert
    for family, mod in (("dense", transformer), ("vlm", transformer), ("moe", transformer),
                        ("ssm", rwkv6), ("hybrid", hybrid), ("encdec", encdec)):
        assert registry.module_for(dataclasses.replace(cfg, family=family)) is mod
    with pytest.raises(ValueError):
        registry.module_for(dataclasses.replace(cfg, family="diffusion"))

"""The port's npec decode, chunked-prefill and windowed streams for the
dense family against the reference's (`repro.npec`), on the CPU.

  * glm4_9b decode: a per-sequence stream (a feed batch of 2) and a 2-slot
    stream seeded by `load_slot` from executed prefills, 8 steps, against
    the reference's `DecodeSession`s;
  * glm4 chunked prefill: two 8-row slices whose banks and logits equal the
    whole-prompt prefill's, and the reference's;
  * starcoder2_3b's windowed decode (ring banks of cfg.window rows, the
    window cut to 8 on both sides) past its wrap, 12 steps.

Float, NPE-8 and NPE-16; weights and tolerances as in
tests/_torch_npec_dense_common.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from _torch_npec_dense_common import (MODES, bits_of, gate, glm4,  # noqa: E402,F401
                                      highest_precision, load, max_err, mode_cfg,
                                      draw_tokens)
from repro.core.overlay import NPEHardware as RefHW  # noqa: E402
from repro_torch.core.overlay import NPEHardware as PortHW  # noqa: E402

STEPS = 8


def _per_sequence(pkg, hw, cfg, mcfg, weights, bits, **kw):
    sess = pkg.DecodeSession(pkg.compile_decode(cfg, 16, hw, bits=bits), weights,
                             batch=2, cfg=mcfg, **kw)
    toks = draw_tokens((2, STEPS), cfg.vocab_size, seed=2)
    outs = [sess.step(toks[:, t:t + 1]) for t in range(STEPS)]
    return outs, dict(sess.caches)


def _two_slots(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """A 2-slot stream seeded by `load_slot` from executed prefills of 5-
    and 9-token prompts, then STEPS steps, the second slot idle for two."""
    sess = pkg.DecodeSession(pkg.compile_decode(cfg, 24, hw, bits=bits, batch=2), weights,
                             cfg=mcfg, **kw)
    outs = []
    for slot, n in enumerate((5, 9)):
        res = pkg.execute(pkg.compile_prefill(cfg, n, hw, bits=bits), weights,
                          {"tokens": draw_tokens((n,), cfg.vocab_size, seed=10 + n)},
                          cfg=mcfg, **kw)
        outs.append(res[0])
        sess.load_slot(slot, res.kv_exports, n)
    toks = draw_tokens((STEPS, 2), cfg.vocab_size, seed=3)
    for t in range(STEPS):
        outs.append(sess.step(toks[t], active=[True, t not in (2, 3)]))
    return outs, dict(sess.caches), np.asarray(sess.pos).tolist()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", ("per_sequence", "two_slots"))
def test_decode_rollout_matches_the_reference(glm4, scenario, mode):
    ref, port, params, tree = glm4
    run = {"per_sequence": _per_sequence, "two_slots": _two_slots}[scenario]
    run_ref = lambda p: run(rn, RefHW(), ref, mode_cfg(ref, mode), p, bits_of(mode))  # noqa: E731
    want = run_ref(params)
    got = run(tn, PortHW(), port, mode_cfg(port, mode), tree, bits_of(mode), device="cpu")
    if scenario == "two_slots":
        assert got[2] == want[2] == [5 + STEPS, 9 + STEPS - 2]
    gate(mode, max_err(want[:2], got[:2]), want[:2], lambda p: run_ref(p)[:2], params)


def _chunks(pkg, hw, cfg, mcfg, weights, bits, **kw):
    """A 16-token prompt as two 8-row slices over 32-row banks, and the
    whole-prompt prefill: both slices' logits, the banks, and the whole
    prefill's logits and kv exports."""
    compiled = pkg.compile_prefill(cfg, 8, hw, bits=bits, cache_len=32)
    prompt = draw_tokens((16,), cfg.vocab_size, seed=7)
    caches = {name: np.zeros(compiled.graph.node(nid).shape, np.float32)
              for name, nid in compiled.graph.caches.items()}
    outs = []
    for c in range(2):
        rows = np.arange(8 * c, 8 * c + 8, dtype=np.int32)
        res = pkg.execute(compiled, weights, dict(caches, tokens=prompt[rows], pos_ids=rows),
                          cfg=mcfg, **kw)
        outs.append(res[0])
        caches.update(res.cache_updates)
    whole = pkg.execute(pkg.compile_prefill(cfg, 16, hw, bits=bits), weights,
                        {"tokens": prompt}, cfg=mcfg, **kw)
    return outs, caches, whole[0], whole.kv_exports


@pytest.mark.parametrize("mode", MODES)
def test_chunked_prefill_equals_whole_prefill(glm4, mode):
    ref, port, params, tree = glm4
    run_ref = lambda p: _chunks(rn, RefHW(), ref, mode_cfg(ref, mode), p, bits_of(mode))  # noqa: E731
    want = run_ref(params)
    got = _chunks(tn, PortHW(), port, mode_cfg(port, mode), tree, bits_of(mode), device="cpu")
    slices, banks, whole, kv = got
    for name, rows in kv.items():
        assert not torch.as_tensor(banks[name])[16:].any()
        if mode == "float":    # the slices seed the banks with the whole prefill's rows
            assert torch.equal(torch.as_tensor(banks[name])[:16], rows)
            assert torch.equal(torch.cat(slices), whole)
    gate(mode, max_err(want, got), want, run_ref, params)


def _ring(pkg, hw, cfg, mcfg, weights, bits, **kw):
    sess = pkg.DecodeSession(pkg.compile_decode(cfg, cfg.window, hw, bits=bits, window=True),
                             weights, batch=2, cfg=mcfg, **kw)
    toks = draw_tokens((2, 12), cfg.vocab_size, seed=4)
    outs = [sess.step(toks[:, t:t + 1]) for t in range(12)]
    assert sess.windowed and int(sess.pos) == 12
    return outs, dict(sess.caches)


@pytest.fixture(scope="module")
def starcoder2():
    return load("starcoder2_3b", window=8)


@pytest.mark.parametrize("mode", MODES)
def test_windowed_ring_past_its_wrap(starcoder2, mode):
    """12 steps over 8-row rings: the appends wrap at step 8 and every
    later step attends over the last 8 tokens."""
    ref, port, params, tree = starcoder2
    run_ref = lambda p: _ring(rn, RefHW(), ref, mode_cfg(ref, mode), p, bits_of(mode))  # noqa: E731
    want = run_ref(params)
    got = _ring(tn, PortHW(), port, mode_cfg(port, mode), tree, bits_of(mode), device="cpu")
    gate(mode, max_err(want, got), want, run_ref, params)
    with pytest.raises(tn.CompileError, match="needs cache_len == cfg.window"):
        tn.compile_decode(port, 16, PortHW(), window=True)

"""The port's serving engine (`NPEEngine`) for the dense family against the
reference's (`repro.npec.runtime`), on glm4_9b's smoke config on the CPU.

  * cost-only engines (whole prompts, 4-row prefill slices, and a 12-slot
    ring window) give the reference's reports and tokens;
  * numeric engines (float, NPE-8, NPE-16) on the reference's weights serve
    the reference engine's tokens for the same requests: admission of
    3 requests on 2 slots, `load_slot` seeding from executed prefills, the
    4-row chunked slices, and the windowed engine's ring past its wrap (a
    prompt of up to 11 tokens and 5 new ones over 12 rows).  Tokens are
    equal, or differ first where the reference's own top-2 margin lies
    below the mode's tolerance (a near tie: NPE 5e-3, float 1e-5); with
    equal tokens the reports are equal;
  * the numeric engine's tokens equal a per-request rollout of the port's
    serving prefill and decode stream (float).

Weights and tolerances are tests/_torch_npec_dense_common.py's; the port
runs with device="cpu".
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.npec as rn  # noqa: E402
import repro_torch.npec as tn  # noqa: E402
from _torch_npec_dense_common import (FLOAT_TOL, NPE_TOL, glm4,  # noqa: E402,F401
                                      highest_precision)
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.overlay import NPEHardware as RefHW  # noqa: E402
from repro.npec.runtime import NPEEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.overlay import NPEHardware as PortHW  # noqa: E402
from repro_torch.npec.runtime import NPEEngine  # noqa: E402

MODES = {"float": (False, 16), "npe8": (True, 8), "npe16": (True, 16)}
ENGINES = {"whole": {}, "chunk4": {"prefill_chunk": 4}, "window": {"window": 12}}
N_REQ = 3


def _kw(variant):
    kw = dict(slots=2, capacity=24, max_new_tokens=5, **ENGINES[variant])
    if variant == "window":
        kw.pop("capacity")
    return kw


def _submit(eng, vocab, n):
    rng = np.random.default_rng(5)
    for _ in range(n):
        eng.submit(rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32))


@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_engine_cost_only_matches_the_reference(variant):
    ref, port = ref_config("glm4_9b", smoke=True), port_config("glm4_9b", smoke=True)
    stats = []
    for Engine, cfg, hw in ((RefEngine, ref, RefHW()), (NPEEngine, port, PortHW())):
        eng = Engine(cfg, hw, **_kw(variant))
        _submit(eng, cfg.vocab_size, 6)
        stats.append(eng.run())
    assert stats[1].report() == stats[0].report()
    assert [r.generated for r in stats[1].requests] == [r.generated for r in stats[0].requests]


def _ref_margin(glm4, variant, mode, prompt, gen) -> float:
    """The reference's top-2 logit margin for the token after prompt + gen,
    served as its engine serves a request: the prompt's serving prefill, its
    kv rows loaded into slot 0 of the 2-slot decode stream (a ring of the
    window's rows for the windowed engine), then gen one token a step."""
    ref, _, params, _ = glm4
    npe, bits = MODES[mode]
    cfg = ref.with_npe(quant_bits=bits) if npe else ref
    windowed = variant == "window"
    hw, kw = RefHW(), _kw(variant)
    res = rn.execute(rn.compile_prefill(ref, len(prompt), hw, bits=bits, window=windowed),
                     params, {"tokens": np.asarray(prompt, np.int32)}, cfg=cfg)
    logits = np.asarray(res[0])[-1]
    if gen:
        cap = kw["window"] if windowed else kw["capacity"]
        sess = rn.DecodeSession(rn.compile_decode(ref, cap, hw, bits=bits, batch=2,
                                                  window=windowed), params, cfg=cfg)
        sess.load_slot(0, res.kv_exports, len(prompt))
        for tok in gen:
            logits = np.asarray(sess.step(np.array([tok, 0], np.int32),
                                          active=[True, False]))[0].reshape(-1)
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_numeric_engine_serves_reference_tokens(glm4, variant, mode):
    ref, port, params, tree = glm4
    npe, bits = MODES[mode]
    want_eng = RefEngine(ref, RefHW(), bits=bits, npe=npe, params=params, **_kw(variant))
    _submit(want_eng, ref.vocab_size, N_REQ)
    want = want_eng.run()
    got_eng = NPEEngine(port, PortHW(), bits=bits, npe=npe, params=tree, device="cpu",
                        **_kw(variant))
    _submit(got_eng, port.vocab_size, N_REQ)
    got = got_eng.run()
    if variant == "window":     # the longest request runs past the ring's wrap
        assert max(len(r.prompt) + len(r.generated) for r in got.requests) > ENGINES[
            "window"]["window"]
    tol = NPE_TOL if npe else FLOAT_TOL
    by_rid = {r.rid: r for r in want.requests}
    assert sorted(by_rid) == sorted(r.rid for r in got.requests)
    for r in got.requests:
        a, b = by_rid[r.rid].generated, r.generated
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == min(len(a), len(b)) or a[i] != b[i])
        margin = _ref_margin(glm4, variant, mode, list(r.prompt), a[:j])
        assert margin < tol, (
            f"request {r.rid} token {j}: port {b[j:j + 1]} vs reference {a[j:j + 1]} "
            f"with the reference's top-2 margin {margin:.3g} >= {tol:g}: not a near tie")
    if all(by_rid[r.rid].generated == r.generated for r in got.requests):
        assert got.report() == want.report()


@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_numeric_engine_matches_its_own_rollouts(glm4, variant):
    """The numeric engine (float) on glm4: each request's tokens equal a
    per-request rollout of the port's serving prefill and decode stream."""
    _, port, _, tree = glm4
    kw = _kw(variant)
    eng = NPEEngine(port, PortHW(), params=tree, device="cpu", **kw)
    _submit(eng, port.vocab_size, N_REQ)
    stats = eng.run()
    cap = kw.get("capacity", kw.get("window"))
    windowed = variant == "window"
    for req in stats.requests:
        prompt = np.asarray(req.prompt, np.int32)
        res = tn.execute(tn.compile_prefill(port, len(prompt), PortHW(), window=windowed), tree,
                         {"tokens": prompt}, cfg=port, device="cpu")
        sess = tn.DecodeSession(tn.compile_decode(port, cap, PortHW(), batch=2,
                                                  window=windowed),
                                tree, cfg=port, device="cpu")
        sess.load_slot(0, res.kv_exports, len(prompt))
        toks = [int(torch.argmax(res[0][-1]))]
        while len(toks) < len(req.generated):
            out = sess.step(np.array([toks[-1], 0], np.int32), active=[True, False])
            toks.append(int(torch.argmax(out[0])))
        assert toks == list(req.generated)

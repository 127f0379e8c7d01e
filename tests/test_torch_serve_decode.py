"""The port's decode server (`repro_torch.launch.serve.Server`) against the
reference's jnp `Server` (`repro.launch.serve.Server`) on the same weights:
the reference's smoke BERT with float32 weights and activations (its
server's config with dtype float32; the caches stay bf16, as in the
reference), its parameters handed to the port through `params_from_jax`.
`Server.generate` must give the same greedy tokens, with the reference's
serving semantics: each slot prefilled alone, then one common position
clock from the longest prompt, the last prompt token fed again there, and
slots with shorter prompts attending over the zero cache rows in between.

Float32, as in tests/test_torch_decode.py: with bf16 activations both sides
agree to about one bf16 ulp of the logits (measured 0.006), and a greedy
choice whose top two logits are one bf16 ulp apart can go either way.

The reference's `generate` returns only its statistics, so the test records
the tokens its jitted decode step returns.

A glm4_9b smoke case (a dense decoder: GQA, RMSNorm, SwiGLU, RoPE) serves
the same way in float; NPE-8 is held to the reference op by op in
tests/test_torch_transformer.py, since the compiled reference can move an
int8 activation by one rounding.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticRequests as RefRequests
from repro.launch import serve as ref_serve
from repro.launch.serve import Server as RefServer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.kernels import KERNELS, LAUNCHES, build, reset_launches
from repro_torch.launch import serve
from repro_torch.launch.serve import Server, ServeStats
from repro_torch.models import registry
from repro_torch.models.convert import params_from_jax

BATCH, MAX_SEQ, GEN = 3, 48, 6


def _prompts(vocab):
    reqs = SyntheticRequests(vocab, max_prompt=16)
    return [reqs.request(i) for i in range(BATCH)]


def _model(params, arch="bert_base"):
    """The port's model of `arch` on the reference server's weights, in float32."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = registry.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model


@pytest.fixture
def ref_float32(monkeypatch):
    """The reference server builds its config in float32."""
    build_cfg = ref_serve.get_config
    monkeypatch.setattr(ref_serve, "get_config", lambda arch, smoke: dataclasses.replace(
        build_cfg(arch, smoke=smoke), dtype="float32"))


def _ref_generate(npe: bool, arch: str = "bert_base"):
    """The reference server's tokens (B, GEN), its params and its cache."""
    ref = RefServer(arch, smoke=True, batch=BATCH, max_seq=MAX_SEQ, npe=npe)
    step, out = ref.decode, []

    def recording(*a):
        tok, cache = step(*a)
        out.append(np.asarray(tok)[:, 0])
        return tok, cache

    ref.decode = recording
    prompts = [RefRequests(ref.cfg.vocab_size, max_prompt=16).request(i)
               for i in range(BATCH)]
    stats = ref.generate(prompts, gen_tokens=GEN)
    assert stats.tokens == BATCH * GEN
    return (np.stack(out, 1), jax.tree.map(np.asarray, ref.params),
            jax.tree.map(np.asarray, ref.cache))


@pytest.mark.parametrize("mode,npe", [("float", False), ("npe-8bit", True)])
def test_generate_matches_reference_server(ref_float32, mode, npe):
    want, params, ref_cache = _ref_generate(npe)
    srv = Server("bert_base", batch=BATCH, max_seq=MAX_SEQ, mode=mode, device="cpu",
                 smoke=True, model=_model(params))
    prompts = _prompts(srv.cfg.vocab_size)
    assert [len(p) for p in prompts] == [15, 10, 14]      # ragged: the clock starts at 15
    stats = srv.generate(prompts, gen_tokens=GEN)
    assert stats.generated.shape == (BATCH, GEN)
    np.testing.assert_array_equal(stats.generated, want)
    assert stats.tokens == BATCH * GEN and len(stats.latencies_ms) == BATCH
    assert len(stats.step_ms) == GEN
    rep = stats.report()
    assert rep["requests"] == BATCH and rep["tokens_per_sec"] > 0
    # the zero rows between a short prompt and the clock stay zero (as in
    # the reference); the re-fed token fills row `start` of every slot
    k = srv.cache["full"]["k"]
    assert not k[:, 1, 10:15].any() and bool(k[:, 1, 15].any())
    assert not np.asarray(ref_cache["full"]["k"][:, 1, 10:15], np.float32).any()


def test_generate_matches_reference_server_glm4(ref_float32):
    want, params, ref_cache = _ref_generate(False, "glm4_9b")
    srv = Server("glm4_9b", batch=BATCH, max_seq=MAX_SEQ, mode="float", device="cpu",
                 smoke=True, model=_model(params, "glm4_9b"))
    stats = srv.generate(_prompts(srv.cfg.vocab_size), gen_tokens=GEN)
    np.testing.assert_array_equal(stats.generated, want)
    k = srv.cache["full"]["k"]
    assert k.shape == (2, BATCH, MAX_SEQ, 2, 32)
    np.testing.assert_array_equal(k[:, :, :15].float().numpy() != 0,
                                  np.asarray(ref_cache["full"]["k"][:, :, :15], np.float32) != 0)


def test_prefill_writes_only_its_slot():
    srv = Server("bert_base", batch=3, max_seq=32, device="cpu", smoke=True)
    srv.prefill_prompt(1, np.arange(7))
    k = srv.cache["full"]["k"]
    assert bool(k[:, 1, :7].any()) and not k[:, 1, 7:].any()
    assert not k[:, 0].any() and not k[:, 2].any()


def test_server_cut_in_depth():
    """A model cut in depth sets the served depth: the config and the cache
    have its layers, and it serves the tokens of the same weights served
    from a fresh server of the cut config."""
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True), num_layers=1)
    model = registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    srv = Server("glm4_9b", batch=2, max_seq=24, device="cpu", smoke=True, model=model)
    assert srv.cfg.num_layers == 1 and len(srv.model.layers) == 1
    assert srv.cache["full"]["k"].shape[0] == 1
    prompts = [np.arange(5), np.arange(3, 9)]
    got = srv.generate(prompts, gen_tokens=3).generated
    again = Server("glm4_9b", batch=2, max_seq=24, device="cpu", smoke=True,
                   model=registry.build_model(cfg, device="cpu",
                                              generator=torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(again.generate(prompts, gen_tokens=3).generated, got)


def test_plain_route_counts_no_launches_and_refuses_overlong_runs():
    reset_launches()
    srv = Server("bert_base", batch=2, max_seq=20, mode="npe-16bit", device="cpu", smoke=True)
    with pytest.raises(ValueError):
        srv.generate([np.arange(16), np.arange(4)], gen_tokens=5)
    stats = srv.generate([np.arange(16), np.arange(4)], gen_tokens=4)
    assert stats.generated.shape == (2, 4)
    assert LAUNCHES == {name: 0 for name in KERNELS}


def test_server_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            Server("bert_base", smoke=True)
        with pytest.raises(RuntimeError):
            build.library()
        with pytest.raises(SystemExit):
            serve.main([])
    finally:
        build.library.cache_clear()


def test_serve_stats_report():
    st = ServeStats(latencies_ms=[1.0, 3.0], step_ms=[2.0, 4.0, 5.0], tokens=6, wall=2.0)
    rep = st.report()
    assert rep["prefill_ms_per_slot"] == 2.0 and rep["decode_ms_per_step"] == 4.0
    assert rep["tokens_per_sec"] == 3.0 and rep["requests"] == 2

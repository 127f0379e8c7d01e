"""Shared helpers of the tests of RWKV6, the hybrid and the encoder-decoder
(tests/test_torch_rwkv6.py, test_torch_hybrid.py, test_torch_encdec.py):
the reference's `Server` run in float32 with its tokens recorded, and the
port's `Server` on the same weights."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.launch import serve as ref_serve
from repro.launch.serve import Server as RefServer
from repro_torch.configs import get_config
from repro_torch.launch.serve import Server
from repro_torch.models import registry
from repro_torch.models.convert import cache_to_numpy, params_from_jax

BATCH, MAX_SEQ, GEN = 3, 24, 5
PROMPTS = [np.arange(5) * 7 % 512, np.arange(9) * 11 % 512, np.arange(7) * 13 % 512]


@pytest.fixture
def ref_float32(monkeypatch):
    """The reference server builds its config in float32."""
    build_cfg = ref_serve.get_config
    monkeypatch.setattr(ref_serve, "get_config", lambda arch, smoke: dataclasses.replace(
        build_cfg(arch, smoke=smoke), dtype="float32"))


def serve_both(arch, npe=False, fill=None):
    """(the reference server's tokens (B, GEN), the port's, the reference's
    cache and the port's, both as float32 numpy): the reference `Server`
    (smoke, float32, seed 0 weights) and the port's on its weights, the
    same prompts.  `fill(cache, params_or_model, is_ref)` may write into
    either cache before the prefills (Whisper's cross cache)."""
    ref = RefServer(arch, smoke=True, batch=BATCH, max_seq=MAX_SEQ, npe=npe)
    if fill is not None:
        fill(ref, True)
    step, want = ref.decode, []

    def recording(*a):
        tok, cache = step(*a)
        want.append(np.asarray(tok)[:, 0])
        return tok, cache

    ref.decode = recording
    ref.generate(PROMPTS, gen_tokens=GEN)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = registry.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    srv = Server(arch, batch=BATCH, max_seq=MAX_SEQ, mode="npe-8bit" if npe else "float",
                 device="cpu", smoke=True, model=model)
    if fill is not None:
        fill(srv, False)
    got = srv.generate(PROMPTS, gen_tokens=GEN).generated
    ref_cache = jax.tree.map(lambda a: np.asarray(a, np.float32), ref.cache)
    return np.stack(want, 1), got, ref_cache, cache_to_numpy(srv.cache)


def frames(cfg, batch, seed=0):
    """Seeded frame embeddings (B, encoder_seq, D) for the encoder stub."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)

"""The port's serving entry point and its refusal to run without a card."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticRequests as RefRequests
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticRequests
from repro_torch.kernels import LAUNCHES, KERNELS, build, ops, reset_launches
from repro_torch.launch import serve_bert
from repro_torch.launch.serve_bert import BertServer
from repro_torch.models import bert

CFG = dataclasses.replace(get_config("bert_base", smoke=True), dtype="float32")


@pytest.fixture
def no_card(monkeypatch):
    """Behave as on a machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.library.cache_clear()
    yield
    build.library.cache_clear()


def _requests(n=3, seq=24):
    reqs = SyntheticRequests(CFG.vocab_size, max_prompt=seq + 8, seed=1)
    return [reqs.request(i) for i in range(n)]


@pytest.mark.parametrize("mode", ["float", "npe-8bit", "npe-16bit"])
def test_server_answers_like_bert_apply(mode):
    server = BertServer(CFG, mode=mode, seq=24, device="cpu")
    reqs = _requests()
    logits, top1 = server.answer(reqs)
    assert logits.shape == (3, 24, CFG.vocab_size) and top1.shape == (3, 24)
    tokens = server.tokens(reqs)
    for i, r in enumerate(reqs):       # zero-padded, or cut, to seq
        r = r[:24]
        assert tokens[i, :len(r)].tolist() == r.tolist()
        assert int(tokens[i, len(r):].abs().sum()) == 0
    want = bert.apply(server.cfg, server.model, tokens)
    assert torch.equal(logits, want)
    assert torch.equal(top1, want.argmax(-1))
    assert bool(torch.isfinite(logits).all())


def test_modes_share_weights_and_plain_route_counts_no_launches():
    reset_launches()
    results, servers, work = serve_bert.serve(batch=2, seq=16, batches=1,
                                              device="cpu", cfg=CFG)
    assert set(results) == set(servers) == set(serve_bert.MODES)
    assert len(work) == 1 and len(work[0]) == 2
    assert all(s.model is servers["float"].model for s in servers.values())
    assert results["float"][1] == 1.0
    assert all(0.0 <= agree <= 1.0 for _, agree in results.values())
    assert LAUNCHES == {name: 0 for name in KERNELS}


def test_server_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.Bert(CFG)


def test_kernel_library_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.library()


def test_cli_without_card_exits(no_card):
    with pytest.raises(SystemExit):
        serve_bert.main(["--batch", "1", "--seq", "8"])


@pytest.mark.parametrize("call", [
    lambda x: ops.pwl_activation(x, "gelu"),
    lambda x: ops.softmax(x),
    lambda x: ops.layernorm(x, torch.ones(8, device="meta"), None),
    lambda x: ops.quant_dense(x, torch.ones(8, 4, device="meta")),
])
def test_wrappers_refuse_other_devices(call):
    """Only a CPU tensor takes the plain route; anything else must launch."""
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        call(torch.ones(4, 8, device="meta"))


def test_synthetic_requests_match_reference():
    ref, port = RefRequests(512, max_prompt=64, seed=3), SyntheticRequests(512, 64, seed=3)
    for i in range(5):
        np.testing.assert_array_equal(port.request(i), ref.request(i))

"""The port's BERT against the reference's (`repro.models.bert` through
`registry.apply`), on the smoke config (2 layers, D=128, 4 q-heads over 2
kv-heads), in float32, on the same weights (the reference's init through
`params_from_jax`) and the same tokens.

Tolerances:
  * float: 1e-5 (the two frameworks sum in other orders; measured 5e-7).
  * NPE-16: NPE_TOL = 5e-3, the reference's own NPE-mode gate
    (tests/conftest.py).
  * NPE-8: a float32 rounding difference that moves an activation across an
    int8 rounding boundary changes that value by a whole quantization step,
    and the change spreads through the layers.  So NPE-8 is held to the
    reference's own sensitivity, measured here on the same input: its change
    when every weight moves by one ulp.  Logits: within twice that change;
    top-1 agreement no lower than that perturbation's, less 0.02.  The first
    layer: within NPE_TOL, or twice the reference's own change where that is
    larger (input seed 0 has a near-tie that a one-ulp nudge flips: measured
    5.36e-3 for both the port and the nudged reference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import bert as ref_bert
from repro.models import registry
from repro_torch.configs import get_config
from repro_torch.models import bert
from repro_torch.models.bert import Bert
from repro_torch.models.convert import params_from_jax

FLOAT_TOL = 1e-5
NPE_TOL = 5e-3
SENSITIVITY_FACTOR = 2.0
TOP1_MARGIN = 0.02

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODES = {"float": lambda c: c, "npe16": lambda c: c.with_npe(16),
         "npe8": lambda c: c.with_npe(8)}


def _cfgs(layers=None):
    over = dict(dtype="float32")
    if layers is not None:
        over["num_layers"] = layers
    return (dataclasses.replace(ref_get_config("bert_base", smoke=True), **over),
            dataclasses.replace(get_config("bert_base", smoke=True), **over))


@pytest.fixture(scope="module")
def ref_params():
    rcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, registry.init_params(rcfg, jax.random.PRNGKey(0)))


def _port(tree, cfg):
    model = Bert(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def _tokens(seed, shape=(2, 32), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _nudge(tree):
    """Every weight moved up by one float32 ulp."""
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


def test_params_from_jax_fills_every_weight(ref_params):
    _, cfg = _cfgs()
    state = params_from_jax(ref_params, cfg)
    model = Bert(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert state[k].shape == v.shape, k


@pytest.mark.parametrize("mode", ["float", "npe16"])
def test_apply_and_encode_match_reference(ref_params, mode):
    rcfg, cfg = (MODES[mode](c) for c in _cfgs())
    model = _port(ref_params, cfg)
    tok = _tokens(0)
    tol = FLOAT_TOL if mode == "float" else NPE_TOL
    want = np.asarray(registry.apply(rcfg, ref_params, jnp.asarray(tok), remat=False))
    got = bert.apply(cfg, model, torch.from_numpy(tok).long())
    assert got.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    want_e = np.asarray(ref_bert.encode(rcfg, ref_params, jnp.asarray(tok)))
    got_e = bert.encode(cfg, model, torch.from_numpy(tok).long())
    np.testing.assert_allclose(got_e.numpy(), want_e, rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_npe8_first_layer(ref_params, seed):
    rcfg, cfg = (c.with_npe(8) for c in _cfgs(layers=1))
    one = dict(ref_params, blocks=jax.tree.map(lambda a: a[:1], ref_params["blocks"]))
    tok = _tokens(seed)
    want = np.asarray(ref_bert.encode(rcfg, one, jnp.asarray(tok)))
    nudged = np.asarray(ref_bert.encode(rcfg, _nudge(one), jnp.asarray(tok)))
    tol = max(NPE_TOL, SENSITIVITY_FACTOR * float(np.abs(nudged - want).max()))
    got = bert.encode(cfg, _port(one, cfg), torch.from_numpy(tok).long()).numpy()
    assert float(np.abs(got - want).max()) <= tol


def test_npe8_logits_within_reference_sensitivity(ref_params):
    rcfg, cfg = (c.with_npe(8) for c in _cfgs())
    tok = jnp.asarray(_tokens(0))
    want = np.asarray(registry.apply(rcfg, ref_params, tok, remat=False))
    nudged = np.asarray(registry.apply(rcfg, _nudge(ref_params), tok, remat=False))
    sens = float(np.abs(nudged - want).max())
    sens_top1 = float((nudged.argmax(-1) == want.argmax(-1)).mean())
    got = bert.apply(cfg, _port(ref_params, cfg), torch.from_numpy(_tokens(0)).long()).numpy()
    assert float(np.abs(got - want).max()) <= SENSITIVITY_FACTOR * sens
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) >= sens_top1 - TOP1_MARGIN


@pytest.fixture(scope="module")
def float_and_npe8():
    """§5.5 in torch alone: the port's own init, float vs NPE-8 logits."""
    _, cfg = _cfgs()
    model = Bert(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(1, (4, 64))).long()
    return (bert.apply(cfg, model, tok).numpy(),
            bert.apply(cfg.with_npe(8, 16), model, tok).numpy())


def test_npe8_top1_agreement(float_and_npe8):
    lf, ln = float_and_npe8
    assert np.mean(lf.argmax(-1) == ln.argmax(-1)) > 0.95


def test_npe8_logit_correlation(float_and_npe8):
    lf, ln = float_and_npe8
    assert np.corrcoef(lf.ravel(), ln.ravel())[0, 1] > 0.99


def test_init_scales():
    """The port's init draws the reference's shapes and scales."""
    cfg = get_config("bert_base", smoke=True)
    model = Bert(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    assert abs(float(model.embed.std()) - 0.02) < 2e-3
    assert abs(float(layer.wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(layer.w2.std()) - cfg.d_ff ** -0.5) < 0.01
    assert float(layer.bq.abs().max()) == 0.0 and float(layer.ln1.beta.abs().max()) == 0.0
    assert float(layer.ln1.gamma.min()) == 1.0

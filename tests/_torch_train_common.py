"""Shared pieces of the training tests: the smoke BERT in each mode and
compute dtype, the reference's loss and gradients by `jax.value_and_grad`
run op by op (under `jax.disable_jit()`), the port's by torch autograd on
the same float32 masters, and the gates they are held to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro_torch.configs import get_config
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models.convert import masters_from_jax, reference_leaf, reference_leaves

MODES = {"float": lambda c: c, "npe16": lambda c: c.with_npe(16),
         "npe8": lambda c: c.with_npe(8)}
TOKENS = (2, 32)

# A gradient entry counts as nonzero above this share of the model's
# largest gradient: below it lie rounding residues such as the key bias's,
# whose exact gradient is 0 (softmax rows do not change under a shift).  In
# bfloat16 the residues are about 2^-8 of the terms that cancel.
ROUNDOFF_FLOOR = {"float32": 1e-6, "bfloat16": 1e-4}


def configs(mode, dtype, layers=None):
    over = dict(dtype=dtype)
    if layers is not None:
        over["num_layers"] = layers
    rc = MODES[mode](dataclasses.replace(ref_get_config("bert_base", smoke=True), **over))
    pc = MODES[mode](dataclasses.replace(get_config("bert_base", smoke=True), **over))
    return rc, pc


def batch(seed=0, shape=TOKENS, vocab=512):
    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, shape).astype(np.int32),
            r.integers(0, vocab, shape).astype(np.int32))


def ref_params(rc, seed=0):
    return jax.tree.map(np.asarray, ref_registry.init_params(rc, jax.random.PRNGKey(seed)))


def ref_value_and_grad(rc, params, tokens, labels):
    """The reference's loss and gradient tree, op by op."""
    def loss_fn(p):
        logits = ref_registry.apply(rc, p, jnp.asarray(tokens), remat=False)
        return ref_cm.cross_entropy(logits, jnp.asarray(labels))
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree.map(lambda g: np.asarray(g, np.float32), grads)


def port_value_and_grad(pc, tree, tokens, labels, remat=True, nudge=False):
    """The port's loss and {name: gradient} on the reference's masters (with
    `nudge`, every master moved up by one float32 ulp)."""
    model = masters_from_jax(tree, pc)
    if nudge:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    model.requires_grad_(True)
    logits = registry.train_apply(pc, model, torch.tensor(tokens), remat=remat)
    loss = cm.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    return float(loss), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def compare_grads(pc, ref_grads, got, base_rtol, noise=None, factor=2.0,
                  same_nonzero=False):
    """Hold each port gradient to the reference's leaf: max-abs error within
    base_rtol of the leaf's largest value, or, where the port's own change
    under 1-ulp masters (`noise`) is larger, within `factor` times that
    change, plus ROUNDOFF_FLOOR of the model's largest gradient.  With
    `same_nonzero`, the entries above that floor that are nonzero must be
    the same.  Returns {name: (error, gate)}."""
    leaves = reference_leaves(pc)
    top = max(float(np.abs(g).max()) for g in got.values())
    floor = ROUNDOFF_FLOOR[pc.dtype] * top
    out = {}
    for name, g in got.items():
        r = reference_leaf(ref_grads, leaves[name])
        assert g.shape == r.shape, name
        err = float(np.abs(g - r).max())
        gate = base_rtol * float(np.abs(r).max()) + floor
        if noise is not None:
            gate = max(gate, factor * float(np.abs(noise[name] - g).max()) + floor)
        out[name] = (err, gate)
        assert err <= gate, (name, err, gate)
        if same_nonzero:
            big = (np.abs(g) > floor) | (np.abs(r) > floor)
            np.testing.assert_array_equal((g != 0) & big, (r != 0) & big, err_msg=name)
    return out

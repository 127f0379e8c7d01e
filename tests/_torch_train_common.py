"""Shared pieces of the training tests: the smoke BERT and the smoke
decoders in each mode and compute dtype, the reference's loss and
gradients by `jax.value_and_grad` run op by op (under `jax.disable_jit()`),
the port's by torch autograd on the same float32 masters, and the gates
they are held to."""
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


def configs(mode, dtype, layers=None, arch="bert_base", **over):
    """The reference's and the port's smoke `arch` in `mode` at compute
    `dtype`, with the same field overrides."""
    over = dict(over, dtype=dtype)
    if layers is not None:
        over["num_layers"] = layers
    rc = MODES[mode](dataclasses.replace(ref_get_config(arch, smoke=True), **over))
    pc = MODES[mode](dataclasses.replace(get_config(arch, smoke=True), **over))
    return rc, pc


def patches(cfg, seed=0, batch=2):
    """Seeded (B, num_patches, D) float32 embeddings: the vlm's stub patches."""
    r = np.random.default_rng(seed + 100)
    return r.normal(0, 1, (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)


def batch(seed=0, shape=TOKENS, vocab=512):
    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, shape).astype(np.int32),
            r.integers(0, vocab, shape).astype(np.int32))


def ref_params(rc, seed=0):
    return jax.tree.map(np.asarray, ref_registry.init_params(rc, jax.random.PRNGKey(seed)))


def ref_value_and_grad(rc, params, tokens, labels, embeds=None):
    """The reference's loss and gradient tree, op by op: the loss of its
    `launch/steps.py` (with embeds, the vlm's patches ahead of the tokens,
    their positions' logits dropped)."""
    kw = {} if embeds is None else {"extra_embeds": jnp.asarray(embeds)}

    def loss_fn(p):
        logits = ref_registry.apply(rc, p, jnp.asarray(tokens), remat=False, **kw)
        if rc.family == "vlm":
            logits = logits[:, rc.num_patches:]
        return ref_cm.cross_entropy(logits, jnp.asarray(labels))
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree.map(lambda g: np.asarray(g, np.float32), grads)


def port_value_and_grad(pc, tree, tokens, labels, remat=True, nudge=False, embeds=None):
    """The port's loss and {name: gradient} on the reference's masters (with
    `nudge`, every master moved by one float32 ulp: up, or down with
    nudge="down")."""
    model = masters_from_jax(tree, pc)
    if nudge:
        toward = float("-inf") if nudge == "down" else float("inf")
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, toward)))
    model.requires_grad_(True)
    extra = None if embeds is None else torch.tensor(embeds)
    logits = registry.train_apply(pc, model, torch.tensor(tokens), remat=remat,
                                  extra_embeds=extra)
    if pc.family == "vlm":
        logits = logits[:, pc.num_patches:]
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


def check_decoder(arch, mode, dtype, base_rtol, loss_tol, seq, seed=0, ref_nudge=False,
                  **over):
    """The smoke decoder `arch`'s loss and every gradient against the
    reference's `jax.value_and_grad`, op by op, on the same masters and a
    (2, seq) batch (the vlm's patches too): the loss within loss_tol, or in
    the NPE modes within twice the port's own change under 1-ulp masters
    (every master one ulp up, or every one down: the larger change; with
    `ref_nudge`, the reference's own change under the same nudges too) where
    that is larger; each gradient by `compare_grads` (base_rtol, the same
    nudge rule; NPE-8: the same nonzero entries).  Returns
    (the port's gradients, the gates' table)."""
    rc, pc = configs(mode, dtype, arch=arch, **over)
    tree = ref_params(rc, seed)
    tokens, labels = batch(seed, (2, seq), rc.vocab_size)
    embeds = patches(rc, seed) if rc.family == "vlm" else None
    want_loss, want = ref_value_and_grad(rc, tree, tokens, labels, embeds)
    got_loss, got = port_value_and_grad(pc, tree, tokens, labels, embeds=embeds)
    nudged = [port_value_and_grad(pc, tree, tokens, labels, embeds=embeds, nudge=way,
                                  remat=False) for way in ("up", "down")]
    changes = [(o[0] - got_loss, {n: o[1][n] - g for n, g in got.items()}) for o in nudged]
    if ref_nudge:
        leaves = reference_leaves(pc)
        for way in (np.inf, -np.inf):
            moved = jax.tree.map(lambda a: np.nextafter(a, np.float32(way)).astype(np.float32),
                                 tree)
            loss, grads = ref_value_and_grad(rc, moved, tokens, labels, embeds)
            changes.append((loss - want_loss, {
                n: reference_leaf(grads, leaves[n]) - reference_leaf(want, leaves[n])
                for n in got}))
    # the largest change of any nudge, as the gradient tree compare_grads reads
    noise = {n: g + max((c[1][n] for c in changes), key=lambda d: float(np.abs(d).max()))
             for n, g in got.items()}
    loss_noise = max(abs(c[0]) for c in changes)
    gate = loss_tol if mode == "float" else max(loss_tol, 2 * loss_noise)
    assert abs(got_loss - want_loss) <= gate, (got_loss, want_loss, gate)
    table = compare_grads(pc, want, got, base_rtol, noise=noise, same_nonzero=mode == "npe8")
    return got, table

"""`launch.steps.build_train_step` and `launch.train.Trainer` against the
reference's on the CPU.

Three steps of the port's train step against three of the reference's
(`repro.launch.steps.build_train_step`, jitted), float mode at float32, on
the same masters (the smoke `bert_base`, the reference's `init_params`) and
the same `SyntheticLM` batches, with whole-batch gradients, with
`microbatch=2` (accumulated in float32) and with `int8_ef` compression (one
scale for each leaf of the reference's tree, which stacks a block weight
over the layers): the losses, the parameters and both moments.

Gates.  AdamW divides each moment by the root of the second, so an entry
whose gradient is small against the rounding of the two libraries moves by
a noisy share of lr (the key biases' exact gradient is 0, a shift of a whole
row of scores: theirs is all rounding residue).  So the parameters are
held by their update over the steps, leaf by leaf:
  * the losses within LOSS_TOL = 1e-5;
  * the moments within MOMENT_RTOL = 1e-4 of their largest value (they are
    linear in the gradients; with `int8_ef`, within 5e-2 in the L2 norm),
    the key biases' excepted;
  * each leaf's update (the parameters less the masters they started
    from) within UPDATE_RTOL = 1e-2 of the reference's update in the L2
    norm (5e-2 with `int8_ef`, where a gradient within an ulp of an int8
    rounding boundary may round a whole step of amax/127 the other way),
    the key biases' excepted, and every entry within 2 lr a step of it.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as rconfig
from repro.launch.steps import build_prefill_step as ref_build_prefill_step
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.optim import adamw as ref_adamw
from _torch_train_common import configs, ref_params
from repro_torch import config as pconfig
from repro_torch.config import FaultConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import build_prefill_step, build_train_step, trainable
from repro_torch.models import registry
from repro_torch.launch.train import Trainer, make_run
from repro_torch.models.convert import masters_from_jax, reference_leaf, reference_leaves
from repro_torch.optim import adamw

STEPS = 3
LR = 1e-3
LOSS_TOL, MOMENT_RTOL = 1e-5, 1e-4
UPDATE_RTOL = {"whole": 1e-2, "microbatch": 1e-2, "int8_ef": 5e-2}

torch.set_float32_matmul_precision("highest")


def _runs(**over):
    rc, pc = configs("float", "float32")
    opt = dict(lr=LR, warmup_steps=1, decay_steps=4, grad_compression=over.pop("comp", "none"))
    shape = ("custom", "train", 16, 4)
    ref = rconfig.RunConfig(model=rc, shape=rconfig.ShapeConfig(*shape),
                            mesh=rconfig.SMOKE_MESH, optimizer=rconfig.OptimizerConfig(**opt),
                            **over)
    port = pconfig.RunConfig(model=pc, shape=pconfig.ShapeConfig(*shape),
                             mesh=pconfig.SMOKE_MESH, optimizer=pconfig.OptimizerConfig(**opt),
                             **over)
    return ref, port


@pytest.mark.parametrize("case", ["whole", "microbatch", "int8_ef"])
def test_three_train_steps_match_reference(case):
    over = {"whole": {}, "microbatch": {"microbatch": 2}, "int8_ef": {"comp": "int8_ef"}}[case]
    rrun, prun = _runs(**over)
    tree = ref_params(rrun.model)
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = ref_adamw.init(rrun.optimizer, rparams)
    rstep = jax.jit(ref_build_train_step(rrun))
    model = masters_from_jax(tree, prun.model).requires_grad_(True)
    popt = adamw.init(prun.optimizer, trainable(model))
    pstep = build_train_step(prun)
    data = SyntheticLM(512, 16, 4, seed=5)
    leaves = reference_leaves(prun.model)
    start = {name: p.detach().clone() for name, p in trainable(model).items()}
    lr_sum = 0.0
    for step in range(STEPS):
        b = data.batch_at(step)
        rparams, ropt, rm = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in b.items()})
        model, popt, pm = pstep(model, popt, {k: torch.tensor(v) for k, v in b.items()})
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_TOL
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        lr_sum += float(rm["lr"])
        for name, p in trainable(model).items():
            where = leaves[name]
            p0 = start[name].numpy()
            want = np.asarray(reference_leaf(rparams, where)) - p0
            got = p.detach().numpy() - p0
            assert float(np.abs(got - want).max()) <= 2 * lr_sum, name
            if name.endswith(".bk"):
                continue
            rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            assert rel <= UPDATE_RTOL[case], (name, rel)
            for mine, ref in ((popt.m[name], ropt.m), (popt.v[name], ropt.v)):
                r = np.asarray(reference_leaf(ref, where))
                d = mine.numpy() - r
                if case == "int8_ef":
                    assert np.linalg.norm(d) <= UPDATE_RTOL[case] * np.linalg.norm(r), name
                else:
                    assert float(np.abs(d).max()) <= MOMENT_RTOL * float(np.abs(r).max()), name
        assert int(popt.step) == int(ropt.step) == step + 1


def test_trainer_recovers_from_injected_crash(tmp_path):
    """A CPU run of the smoke BERT crashes at step 5 (injected), restores
    the checkpoint of step 3 and runs on; the steps it runs again give the
    losses they gave the first time (the same data, the same state)."""
    run = make_run("bert_base", smoke=True, steps=8, batch=2, seq=16, npe=True,
                   ckpt_dir=str(tmp_path),
                   fault=FaultConfig(inject_crash_at_step=5, max_restarts=2))
    run = dataclasses.replace(run, checkpoint=dataclasses.replace(run.checkpoint, interval=4,
                                                                  async_save=True))
    logs = []
    trainer = Trainer(run, log=logs.append, device="cpu")
    out = trainer.train()
    assert out["restarts"] == 1
    assert out["fault_events"][0].kind == "crash" and out["fault_events"][0].step == 5
    assert any("[recover] restored checkpoint at step 3" in line for line in logs)
    steps = [h["step"] for h in out["history"]]
    assert steps == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    first, again = out["history"][4]["loss"], out["history"][5]["loss"]
    assert first == again
    assert np.isfinite(out["final_loss"])
    assert trainer.ckpt.latest_step() == 7
    assert int(trainer.opt_state.step) == 8


def test_runs_without_a_directory_do_not_share_checkpoints(tmp_path, monkeypatch):
    """Without ckpt_dir each run checkpoints into a fresh directory: a run
    after a longer one keeps its own step-0 checkpoint (in a shared one the
    longer run's later steps would sort after it and push it out of `keep`)
    and recovers from a crash through it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    quiet = dict(log=lambda *a: None, device="cpu")
    long_run = make_run("bert_base", smoke=True, steps=6, batch=1, seq=8)
    long_run = dataclasses.replace(long_run, checkpoint=dataclasses.replace(
        long_run.checkpoint, interval=1, async_save=False))
    Trainer(long_run, **quiet).train()
    short = make_run("bert_base", smoke=True, steps=3, batch=1, seq=8,
                     fault=FaultConfig(inject_crash_at_step=1, max_restarts=1))
    assert short.checkpoint.directory != long_run.checkpoint.directory
    out = Trainer(short, **quiet).train()
    assert out["restarts"] == 1
    assert [h["step"] for h in out["history"]] == [0, 1, 2]


def test_trainer_refuses_what_the_port_cannot_train():
    with pytest.raises(NotImplementedError, match="dense mode"):
        Trainer(make_run("glm4_9b", smoke=True, steps=1, batch=1, seq=8), device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        Trainer(make_run("bert_base", smoke=True, steps=1, batch=1, seq=8, mesh_shape=(2, 1)),
                device="cpu")


def test_prefill_step_is_the_last_positions_logits():
    """`build_prefill_step` against the reference's on the same masters: the
    last position's logits, (B, V), in float32 within 1e-5."""
    rrun, prun = _runs()
    tree = ref_params(rrun.model)
    tokens = SyntheticLM(512, 16, 4, seed=6).batch_at(0)["tokens"]
    want = jax.jit(ref_build_prefill_step(rrun))(jax.tree.map(jnp.asarray, tree),
                                                  {"tokens": jnp.asarray(tokens)})
    model = masters_from_jax(tree, prun.model)
    got = build_prefill_step(prun)(model, {"tokens": torch.tensor(tokens)})
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(got, registry.apply(prun.model, model, torch.tensor(tokens))[:, -1])

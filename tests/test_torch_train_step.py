"""`launch.steps.build_train_step` and `launch.train.Trainer` against the
reference's on the CPU.

Three steps of the port's train step against three of the reference's
(`repro.launch.steps.build_train_step`, jitted), float mode at float32, on
the same masters (the smoke `bert_base`, the reference's `init_params`) and
the same `SyntheticLM` batches, with whole-batch gradients, with
`microbatch=2` (accumulated in float32) and with `int8_ef` compression (one
scale for each leaf of the reference's tree, which stacks a block weight
over the layers): the losses, the parameters and both moments.

The same three steps of the smoke glm4_9b (a dense decoder) and
qwen2_vl_7b (its batch with 16 seeded patch embeddings ahead of the
tokens, whose logits the loss drops), with whole-batch gradients, through
the dense mode's backward (its CPU route); the trainer refuses RWKV6,
Hymba and Whisper, whose backward passes are not ported, trains a smoke
decoder from the CLI, and AdamW's update, now written in place, gives the
bits of the out-of-place update it replaced.

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
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import Trainer, make_run
from repro_torch.models.convert import masters_from_jax, reference_leaf, reference_leaves
from repro_torch.optim import adamw

STEPS = 3
LR = 1e-3
LOSS_TOL, MOMENT_RTOL = 1e-5, 1e-4
UPDATE_RTOL = {"whole": 1e-2, "microbatch": 1e-2, "int8_ef": 5e-2}

torch.set_float32_matmul_precision("highest")


def _runs(arch="bert_base", **over):
    rc, pc = configs("float", "float32", arch=arch)
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
    _three_steps(case, _runs(**over))


@pytest.mark.parametrize("arch", ["glm4_9b", "qwen2_vl_7b"])
def test_three_decoder_train_steps_match_reference(arch):
    _three_steps("whole", _runs(arch))


def _three_steps(case, runs):
    """STEPS steps of both train steps from the same masters and batches,
    held by the module's gates."""
    rrun, prun = runs
    tree = ref_params(rrun.model)
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = ref_adamw.init(rrun.optimizer, rparams)
    rstep = jax.jit(ref_build_train_step(rrun))
    model = masters_from_jax(tree, prun.model).requires_grad_(True)
    popt = adamw.init(prun.optimizer, trainable(model))
    pstep = build_train_step(prun)
    patches = prun.model.num_patches if prun.model.family == "vlm" else 0
    data = SyntheticLM(512, 16 - patches, 4, seed=5)
    leaves = reference_leaves(prun.model)
    start = {name: p.detach().clone() for name, p in trainable(model).items()}
    lr_sum = 0.0
    for step in range(STEPS):
        b = data.batch_at(step)
        if patches:
            r = np.random.default_rng(step)
            b["embeds"] = r.normal(0, 1, (4, patches, prun.model.d_model)).astype(np.float32)
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
    """RWKV6 (ssm), Hymba (hybrid) and Whisper (encdec) raise, naming what
    they lack; a dense, a vlm and an MoE decoder build; so does a mesh of
    more than one device."""
    for arch, lacks in (("rwkv6_3b", "RWKV6 recurrence"), ("hymba_1_5b", "Mamba recurrence"),
                        ("whisper_base", "encoder-decoder")):
        with pytest.raises(NotImplementedError, match=lacks):
            Trainer(make_run(arch, smoke=True, steps=1, batch=1, seq=8), device="cpu")
    for arch in ("glm4_9b", "qwen2_vl_7b", "granite_moe_1b_a400m"):
        assert Trainer(make_run(arch, smoke=True, steps=1, batch=1, seq=24),
                       log=lambda *a: None, device="cpu").model.cfg.name
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


def test_trainer_cli_trains_a_smoke_decoder(tmp_path, capsys):
    """`python -m repro_torch.launch.train --arch starcoder2_3b --smoke
    --device cpu`: 3 steps of the windowed decoder (40 positions past its
    window of 32), finite losses."""
    train_mod.main(["--arch", "starcoder2_3b", "--smoke", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "40", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: final loss" in out
    final = float(out.split("done: final loss ")[1].split(",")[0])
    assert np.isfinite(final)


def _update_out_of_place(cfg, grads, state, params):
    """The out-of-place AdamW update that `adamw.update` replaced: new
    parameters and moments, the inputs untouched."""
    F32 = torch.float32
    step = state.step + 1
    lr = adamw.schedule(cfg, step)
    gnorm = adamw.global_norm(grads)
    scale = (torch.minimum(torch.tensor(1.0), cfg.grad_clip / torch.maximum(gnorm, torch.tensor(1e-9)))
             if cfg.grad_clip > 0 else 1.0)
    mdt = getattr(torch, cfg.moment_dtype)
    sf = step.to(F32)
    c1 = 1 - torch.tensor(cfg.b1, dtype=F32) ** sf
    c2 = 1 - torch.tensor(cfg.b2, dtype=F32) ** sf
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        g = grads[k].to(F32) * scale
        m1 = cfg.b1 * state.m[k].to(F32) + (1 - cfg.b1) * g
        v1 = cfg.b2 * state.v[k].to(F32) + (1 - cfg.b2) * g * g
        delta = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps) + cfg.weight_decay * params[k].to(F32)
        new_p[k] = (params[k].to(F32) - lr * delta).to(params[k].dtype)
        new_m[k], new_v[k] = m1.to(mdt), v1.to(mdt)
    return new_p, new_m, new_v


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_in_place_adamw_gives_the_out_of_place_bits(moments, param_dtype):
    """Four steps of the in-place update (clip 1, weight decay 0.1, a
    gradient that the clip scales at step 1): every parameter and moment
    bit for bit those of the out-of-place update, written into the tensors
    it was given (the same storage), a leaf at a time."""
    cfg = pconfig.OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=6, moment_dtype=moments,
                                  weight_decay=0.1, grad_clip=1.0)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 33, generator=gen).to(param_dtype),
              "b": torch.randn(7, generator=gen).to(param_dtype)}
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    state = adamw.init(cfg, params)
    mptrs = {k: (state.m[k].data_ptr(), state.v[k].data_ptr()) for k in params}
    want_p = {k: p.clone() for k, p in params.items()}
    want_m, want_v = dict(state.m), dict(state.v)
    want_m = {k: t.clone() for k, t in want_m.items()}
    want_v = {k: t.clone() for k, t in want_v.items()}
    for step in range(4):
        grads = {k: torch.randn(p.shape, generator=gen) * (30.0 if step == 1 else 0.5)
                 for k, p in params.items()}
        want_p, want_m, want_v = _update_out_of_place(
            cfg, grads, adamw.OptState(state.step, want_m, want_v), want_p)
        got_p, state, _ = adamw.update(cfg, grads, state, params)
        assert got_p is params
        for k in params:
            assert torch.equal(params[k], want_p[k]) and params[k].data_ptr() == ptrs[k]
            assert torch.equal(state.m[k], want_m[k]) and torch.equal(state.v[k], want_v[k])
            assert (state.m[k].data_ptr(), state.v[k].data_ptr()) == mptrs[k]
            assert state.m[k].dtype == getattr(torch, moments)
        assert int(state.step) == step + 1

"""The port's training substrate against the reference's: the run
dataclasses field for field, `SyntheticLM`, AdamW and its schedules,
int8 error-feedback compression, the fault supervisor, the checkpointer.

Tolerances:
  * SyntheticLM, compress_decompress, the configs, checkpoints: exact.
  * AdamW with float32 moments: 1e-6 relative to each leaf's largest value
    (pow, sqrt and divide may round differently in the two libraries, by an
    ulp, and an ulp of a moment moves the update by about as much).
  * AdamW with bfloat16 moments: a moment may round to the neighbouring
    bf16 value, 2^-8 relative; the parameters stay within 1e-6 relative.
"""
import dataclasses
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.config as rconfig
from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.optim import adamw as ref_adamw
from repro.runtime import compression as ref_compression
import repro_torch.config as pconfig
from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.config import FaultConfig, OptimizerConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import adamw
from repro_torch.runtime import compression
from repro_torch.runtime.fault import Supervisor, TrainingFailure, run_with_recovery

RUN_CLASSES = ["ShapeConfig", "MeshConfig", "OptimizerConfig", "CheckpointConfig",
               "FaultConfig", "RunConfig"]


@pytest.mark.parametrize("name", RUN_CLASSES)
def test_run_dataclasses_field_for_field(name):
    ref, port = getattr(rconfig, name), getattr(pconfig, name)
    rf, pf = dataclasses.fields(ref), dataclasses.fields(port)
    assert [f.name for f in rf] == [f.name for f in pf]
    for a, b in zip(rf, pf):
        da, db = a.default, b.default
        if dataclasses.is_dataclass(da):
            assert type(da).__name__ == type(db).__name__, a.name
            da, db = dataclasses.astuple(da), dataclasses.astuple(db)
        assert da == db, a.name
        assert str(a.type) == str(b.type), a.name
    assert ref.__dataclass_params__.frozen == port.__dataclass_params__.frozen


def test_shape_tables_and_meshes():
    for table in ("SHAPES", "SMOKE_SHAPES"):
        ref, port = getattr(rconfig, table), getattr(pconfig, table)
        assert {k: dataclasses.astuple(v) for k, v in ref.items()} == \
            {k: dataclasses.astuple(v) for k, v in port.items()}
    for mesh in ("SINGLE_POD", "MULTI_POD", "SMOKE_MESH"):
        r, p = getattr(rconfig, mesh), getattr(pconfig, mesh)
        assert dataclasses.astuple(r) == dataclasses.astuple(p)
        assert r.num_devices == p.num_devices and r.describe() == p.describe()


@pytest.mark.parametrize("seed,step,hosts,host", [(0, 0, 1, 0), (3, 5, 1, 0), (3, 5, 2, 1),
                                                   (7, 123, 4, 2)])
def test_synthetic_lm_equals_reference(seed, step, hosts, host):
    kw = dict(vocab_size=30720, seq_len=64, global_batch=8, seed=seed, num_hosts=hosts,
              host_id=host)
    want, got = RefSyntheticLM(**kw).batch_at(step), SyntheticLM(**kw).batch_at(step)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _tree(seed, shapes=(("a", (5, 7)), ("b", (11,)), ("c", (3, 2, 4)))):
    r = np.random.default_rng(seed)
    return {name: r.normal(0, 1, shape).astype(np.float32) for name, shape in shapes}


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,clip", [("cosine", 1.0), ("linear", 0.0), ("constant", 5.0)])
def test_adamw_update_equals_reference(moments, schedule, clip):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, decay_steps=6, schedule=schedule,
                  moment_dtype=moments, grad_clip=clip)
    rcfg, pcfg = rconfig.OptimizerConfig(**cfg_kw), OptimizerConfig(**cfg_kw)
    params = _tree(0)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.tensor(v) for k, v in params.items()}
    rs, ps = ref_adamw.init(rcfg, rp), adamw.init(pcfg, pp)
    for step in range(4):
        grads = {k: v * (3.0 if step == 1 else 0.5) for k, v in _tree(10 + step).items()}
        rp, rs, rm = ref_adamw.update(rcfg, {k: jnp.asarray(v) for k, v in grads.items()}, rs, rp)
        pp, ps, pm = adamw.update(pcfg, {k: torch.tensor(v) for k, v in grads.items()}, ps, pp)
        assert int(ps.step) == int(rs.step) == step + 1
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        mtol = 2.0 ** -8 if moments == "bfloat16" else 1e-6
        for k in params:
            _assert_rel(pp[k].numpy(), rp[k], 1e-6)
            assert str(ps.m[k].dtype).replace("torch.", "") == moments
            _assert_rel(ps.m[k].float().numpy(), np.asarray(rs.m[k], np.float32), mtol)
            _assert_rel(ps.v[k].float().numpy(), np.asarray(rs.v[k], np.float32), mtol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_equals_reference(schedule):
    rcfg = rconfig.OptimizerConfig(lr=3e-4, warmup_steps=10, decay_steps=100, schedule=schedule)
    pcfg = OptimizerConfig(lr=3e-4, warmup_steps=10, decay_steps=100, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        want = float(ref_adamw.schedule(rcfg, jnp.int32(step)))
        got = adamw.schedule(pcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_global_norm_and_clip_report_raw_norm():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=0, schedule="constant", grad_clip=1.0,
                          weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, _, metrics = adamw.update(cfg, {"w": torch.full((4,), 1e6)}, adamw.init(cfg, params),
                                 params)
    assert float(metrics["grad_norm"]) > 1e5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_equals_reference(seed):
    grads = _tree(20 + seed, (("w", (64, 3)), ("b", (17,))))
    error = {k: v * 1e-3 for k, v in _tree(30 + seed, (("w", (64, 3)), ("b", (17,)))).items()}
    rd, re = ref_compression.compress_decompress(
        {k: jnp.asarray(v) for k, v in grads.items()}, {k: jnp.asarray(v) for k, v in error.items()})
    pd, pe = compression.compress_decompress(
        {k: torch.tensor(v) for k, v in grads.items()}, {k: torch.tensor(v) for k, v in error.items()})
    for k in grads:
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(rd[k]))
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(re[k]))
    zero = compression.init_error({k: torch.tensor(v) for k, v in grads.items()})
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32 for z in zero.values())


# --- the fault supervisor (tests/test_substrate.py's cases) -----------------

def test_recovery_from_injected_nan():
    sup = Supervisor(FaultConfig(inject_nan_at_step=3, max_restarts=2))
    state = {"restored": 0, "completed_steps": []}

    def loop(start):
        for s in range(start, 6):
            sup.check_loss(s, 1.0)
            state["completed_steps"].append(s)
        return {"ok": True}

    def restore():
        state["restored"] += 1
        return 2

    out = run_with_recovery(loop, restore, sup)
    assert out["ok"] and state["restored"] == 1
    assert sup.events[0].kind == "nan"
    assert 3 in state["completed_steps"][-4:]


def test_recovery_gives_up_after_max_restarts():
    sup = Supervisor(FaultConfig(max_restarts=1))

    def loop(start):
        raise TrainingFailure("always")

    with pytest.raises(TrainingFailure, match="max_restarts"):
        run_with_recovery(loop, lambda: 0, sup)


def test_straggler_detection_and_injected_crash():
    sup = Supervisor(FaultConfig(step_deadline_sec=0.1, inject_crash_at_step=2))
    sup.check_deadline(5, elapsed=0.5)
    assert sup.events and sup.events[0].kind == "straggler"
    sup.check_crash(1)
    with pytest.raises(TrainingFailure):
        sup.check_crash(2)
    assert sup.events[-1].kind == "crash" and sup.events[-1].action == "rewind"


# --- checkpoints --------------------------------------------------------------

def _state():
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": {"c": torch.linspace(-3, 3, 7).to(torch.bfloat16)}}
    return {"params": params, "opt": adamw.init(OptimizerConfig(moment_dtype="bfloat16"), params)}


def test_checkpoint_roundtrip_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    state = _state()
    state["opt"] = state["opt"]._replace(step=torch.tensor(5, dtype=torch.int32))
    ck.save(7, state)
    template = T.tree_map(torch.zeros_like, state)
    restored, step = ck.restore(template)
    assert step == 7
    for (k, a), (_, b) in zip(T.flatten_with_path(state), T.flatten_with_path(restored)):
        assert a.dtype == b.dtype, k
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), k
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["leaves"]["params/b/c"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt/.step"] == {"shape": [], "dtype": "int32"}


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.zeros(2)})
    assert ck.latest_step() == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002", "step_00000003"]
    assert (tmp_path / "LATEST").read_text() == "step_00000003"


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, {"x": torch.arange(10)})
    ck.wait()
    out, step = ck.restore({"x": torch.zeros(10, dtype=torch.int32)})
    assert step == 1 and out["x"].dtype == torch.int32
    assert torch.equal(out["x"], torch.arange(10, dtype=torch.int32))


def test_checkpoint_written_by_reference(tmp_path):
    """The reference's checkpointer writes, the port's reads (and the other
    way): the same keys, bf16 through its uint16 view."""
    r = np.random.default_rng(0)
    a = r.normal(size=(3, 4)).astype(np.float32)
    c = r.normal(size=(5,)).astype(np.float32)
    params = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c).astype(jnp.bfloat16)}}
    state = {"params": params, "opt": ref_adamw.init(rconfig.OptimizerConfig(), params)}
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(4, state)
    pparams = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}}
    template = {"params": pparams, "opt": adamw.init(OptimizerConfig(), pparams)}
    got, step = Checkpointer(str(tmp_path / "ref")).restore(template)
    assert step == 4
    np.testing.assert_array_equal(got["params"]["a"].numpy(), a)
    np.testing.assert_array_equal(got["params"]["b"]["c"].float().numpy(),
                                  np.asarray(params["b"]["c"].astype(jnp.float32)))
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 0
    Checkpointer(str(tmp_path / "port"), async_save=False).save(9, got)
    back, step = RefCheckpointer(str(tmp_path / "port")).restore(state)
    assert step == 9
    assert back["params"]["b"]["c"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(back["params"]["b"]["c"]),
                                  np.asarray(params["b"]["c"]))

"""The port stands alone: no module of `repro_torch` (the npec compiler,
executor and runtime among them), and not `chip_smoke.py`, imports `jax` or
anything of the reference package `repro`.

A child process installs an import hook that refuses those top-level names
(exactly those names, so `repro_torch` itself passes), imports every module
of the port and `chip_smoke` (without running it), and lists what reached
sys.modules."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "repro"}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
print("modules", len(names))
print("names", " ".join(names))
print("leaked", leaked)
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["leaked"] == "[]"
    assert int(lines["modules"]) >= 34
    names = set(lines["names"].split())
    for new in ("kernels.flash_attention", "models.registry", "launch.steps", "launch.serve",
                "npec.exec", "npec.trace", "npec.lower", "core.overlay",
                "core.cycles", "npec.runtime.engine", "npec.fleet.sim", "npec.obs.tracer",
                "core.fixedpoint", "models.transformer", "configs.glm4_9b",
                "configs.command_r_plus_104b", "configs.qwen2_vl_7b", "models.moe",
                "configs.starcoder2_3b", "configs.gemma3_27b",
                "configs.granite_moe_1b_a400m", "configs.llama4_maverick_400b_a17b",
                "kernels.ops", "kernels.nvu_softmax", "optim.adamw", "launch.train",
                "models.convert", "models.common"):
        assert "repro_torch." + new in names
    npec = {n for n in names if n.startswith("repro_torch.npec")}
    for mod in ("npec", "npec.ir", "npec.lower", "npec.schedule", "npec.trace", "npec.exec",
                "npec.runtime", "npec.fleet", "npec.fleet.partition", "npec.obs"):
        assert "repro_torch." + mod in npec

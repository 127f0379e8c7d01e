"""Checkpointing: a manifest and one npz of leaves, async save (counterpart
of `repro/checkpoint/ckpt.py`, with its on-disk layout).

Layout:
    <dir>/step_000123/manifest.json     {step, leaves: {key: {shape,dtype}}}
    <dir>/step_000123/arrays.npz        key -> np array
    <dir>/LATEST                        "step_000123"

A leaf's key is its path in the tree, "/"-joined (`repro_torch.tree`), as
the reference writes it, so each package reads the other's checkpoints of
the same tree.  bfloat16, which npz cannot store, is written as a uint16
view and named in the manifest.

Commit protocol: write into step_XXXX.tmp, atomic rename, then update
LATEST, so a crash mid-save never corrupts the latest checkpoint.  Async
mode copies the tensors to host memory at once and writes them on a
background thread; `wait()` joins it.  `restore(template)` puts each leaf
on its template leaf's device and in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16, "float16": torch.float16,
                "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_host(t) -> np.ndarray:
    """A numpy copy of a tensor (bf16 as its uint16 bits) or of an array."""
    if not isinstance(t, torch.Tensor):
        return np.array(t, copy=True)
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # --- save ---------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot to host, then commit (async if configured)."""
        self.wait()                      # one in-flight save at a time
        flat = T.flatten_with_path(tree)
        host = {k: _to_host(v) for k, v in flat}
        dtypes = {k: (_dtype_name(v) if isinstance(v, torch.Tensor) else str(np.asarray(v).dtype))
                  for k, v in flat}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, dtypes, extra or {})

    def _write(self, step: int, host: dict, dtypes: dict, extra: dict):
        name = f"step_{step:08d}"
        tmp = self.dir / (name + ".tmp")
        final = self.dir / name
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **host)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            **extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(name)
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if p.is_dir())
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --- restore ------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        return int(latest.read_text().strip().split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """The checkpoint of `step` (default the latest) in the structure of
        `template`, each leaf a tensor on its template leaf's device and in
        its dtype."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat = {}
        with np.load(path / "arrays.npz") as z:
            for k in z.files:
                arr = z[k]
                saved = manifest["leaves"].get(k, {}).get("dtype")
                if saved == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr, copy=True))
                flat[k] = t
        values = []
        for key, leaf in T.flatten_with_path(template):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = flat[key]
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            values.append(t)
        return T.unflatten(template, values), step

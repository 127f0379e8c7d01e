"""Build and load the CUDA C++ kernels of `repro_torch/csrc/`.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a`, and the objects are linked into one shared library
with a plain C interface that `ctypes` loads.  The library goes into
`repro_torch/_build/<hash of the sources and flags>/` at first use, so a
changed source builds anew and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises if that is not 0.  A failed build
raises with nvcc's output.  Nothing here falls back to another route.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libnpe_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points: name -> argument types (every one returns an int: a
# cudaError_t, or for npe_quant_matmul_workspace a count).
SIGNATURES = {
    # x, y, n, x_bf16, y_bf16, table, segments, stream
    "npe_pwl_eval": (P, P, LL, I, I, P, I, P),
    # xq, wq, x_scale, x_scale_stride, w_scale, out, m, n, k, out_bf16, table,
    # segments, workspace, stream
    "npe_quant_matmul": (P, P, P, I, P, P, I, I, I, I, P, I, P, P),
    # m, n, k -> int32 values of the zeroed workspace npe_quant_matmul needs
    "npe_quant_matmul_workspace": (I, I, I),
    # x, dy, dx, n, bf16, slope_table, segments, clamped, lo, hi, stream
    "npe_pwl_eval_grad": (P, P, P, LL, I, P, I, I, F, F, P),
    # x, dy, dx, rows, n, causal_rows, limit, limit_rows, scale, dy_bf16,
    # exp_table, exp_slopes, exp_segments, exp_lo, exp_hi, recip_table,
    # recip_slopes, recip_segments, recip_lo, recip_hi, stream
    "npe_nvu_softmax_grad": (P, P, P, I, I, I, P, I, F, I, P, P, I, F, F, P, P, I, F, F, P),
    # x, dy, gamma, dx, rows, n, bf16, rms_only, segments -> the blocks of
    # the backward's grid (the rows of its column sums), or minus an error
    "npe_nvu_layernorm_grad_blocks": (P, P, P, P, I, I, I, I, I),
    # x, dy, gamma, dx, dgamma, dbeta, parts, parts_blocks, rows, n, bf16,
    # eps, rms_only, table, slopes, segments, lo, hi, stream
    "npe_nvu_layernorm_grad": (P, P, P, P, P, P, P, I, I, I, I, F, I, P, P, I, F, F, P),
    # x, y, rows, n, causal_rows, limit, limit_rows, scale, y_bf16, exp_table,
    # exp_segments, recip_table, recip_segments, stream
    "npe_nvu_softmax": (P, P, I, I, I, P, I, F, I, P, I, P, I, P),
    # x, y, gamma, beta, rows, n, bf16, eps, rms_only, table, segments, stream
    "npe_nvu_layernorm": (P, P, P, P, I, I, I, F, I, P, I, P),
    # q, k, v, out, 16 element strides (q, k, v, out; each B, H, S, D),
    # batch, hq, hkv, sq, skv, d, kv_len, q_bf16, kv_bf16, out_bf16, causal,
    # window, scale, use_pwl, block_q, block_kv, exp_table, exp_segments,
    # recip_table, recip_segments, stream
    "npe_flash_attention": (P, P, P, P, *(LL,) * 16, *(I,) * 12, F, I, I, I,
                            P, I, P, I, P),
    # the dense mode: q, k, v, out, 16 element strides, batch, hq, hkv, sq,
    # skv, d, kv_len, q_bf16, out_bf16, causal, window, scale, softcap,
    # use_pwl, exp_table, exp_segments, recip_table, recip_segments,
    # tanh_table, tanh_segments, tanh_lo, tanh_hi, row statistics (or null),
    # stream
    "npe_attention_dense": (P, P, P, P, *(LL,) * 16, *(I,) * 11, F, F, I, P, I, P, I, P, I,
                            F, F, P, P),
    # the decode instance's cluster size for batch, hq, hkv, sq, kv_len,
    # window, d (0: another instance)
    "npe_attention_dense_split": (I,) * 7,
    # the dense mode's backward: q, k, v, do, the forward's row statistics,
    # dq, dk, dv (bf16), the (m, norm, dS, share) workspace, 16 element
    # strides (q, k, v, do), batch, hq, hkv, sq, skv, d, q_bf16, causal,
    # window, scale, softcap, use_pwl, then for exp, recip and tanh: table,
    # slopes, segments, lo, hi; stream
    "npe_attention_dense_grad": (P, P, P, P, P, P, P, P, P, *(LL,) * 16, *(I,) * 9, F, F, I,
                                 *(P, P, I, F, F) * 3, P),
    # stream: one empty 256-thread block, the launch floor chip_smoke.py times
    "npe_launch_floor": (P,),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    log: str          # nvcc's output, with ptxas's register and spill lines
    cached: bool


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile the kernels (or find them built) and return the library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log, cached=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            logf = open(Path(tmp) / (cu.stem + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            procs.append((cu, obj, logf, subprocess.Popen(
                cmd, stdout=logf, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for cu, _, logf, proc in procs:
            rc = proc.wait()
            logf.seek(0)
            text = logf.read()
            logf.close()
            logs.append(f"== {cu.name}\n{text}")
            if rc != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all or nothing
    return BuildResult(lib, time.perf_counter() - t0, log, cached=False)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library.  Raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the repro_torch kernels run only on the card")
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str) -> None:
    """Wrappers take CPU tensors (plain route) or CUDA tensors (kernel)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}, expected cuda or cpu")

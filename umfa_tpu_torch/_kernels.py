"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface and loaded with ctypes (no PyTorch headers,
so a build takes seconds). Builds happen at first use, into `_build/` beside
this file (git-ignored); the library name carries a hash of the sources and
flags, so an edited source is rebuilt. `build_all()` starts one nvcc per
source, all at once.

Nothing here runs at import time: modules that import this one must stay
importable where there is no nvcc and no GPU; nvcc runs only when a kernel
is first asked for.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_fwd", "quant_attn_fwd", "flash_bwd", "flash_dbias", "quant_rows",
           "fused_qattn", "quant_bwd", "flash_decode", "ring_attn", "mma_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per kernel (not per library: `flash_bwd` holds `flash_bwd_dq` and
# `flash_bwd_dkv`, `quant_bwd` holds `quant_bwd_dq` and `quant_bwd_dkv`,
# `ring_attn` holds `ring_fwd_step`, `ring_bwd_dkv` and `ring_bwd_dq`),
# counted by each wrapper right after its kernel was launched (and nowhere
# else). `flash_dbias` also counts under "flash_dbias/<dtype>" (float32,
# float16, bfloat16), which splits its launches by input type.
launches: collections.Counter = collections.Counter()

_libs: dict = {}
_fns: dict = {}


def reset_launch_counts() -> None:
    launches.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "umfa_tpu_torch CUDA kernels are built from source at first use"
        )
    return str(nvcc)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_SRC.glob("*.cuh")) + [_SRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict:
    """Build every kernel library that is not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds", "ptxas"}};
    raises RuntimeError with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.umfa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.umfa_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def function(name: str, symbol: str, argtypes):
    """The C function `symbol` of kernel library `name`, with its argtypes
    declared (pointers and the stream as c_void_p) and an int result (the
    cudaError_t of the launch). While torch.profiler records, each call is
    a range named `symbol` without its `umfa_` prefix (`flash_fwd`,
    `flash_bwd_dq`, ...), so a trace names the launches' wrappers beside
    the kernels they ran."""
    key = (name, symbol)
    if key not in _fns:
        fn = getattr(_lib(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        range_name = symbol.removeprefix("umfa_")

        def call(*args):
            if torch.autograd._profiler_enabled():
                with torch.profiler.record_function(range_name):
                    return fn(*args)
            return fn(*args)

        _fns[key] = call
    return _fns[key]


def check(name: str, err: int, kernel: str | None = None, n: int = 1) -> None:
    """Raise if a call into library `name` returned a CUDA error; else count
    its n launches of `kernel` (default: the library's own name)."""
    if err != 0:
        msg = _lib(name).umfa_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel or name} kernel launch failed: CUDA error {err} ({msg})")
    launches[kernel or name] += n

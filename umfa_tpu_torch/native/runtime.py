"""ctypes binding of the native runtime (port of umfa_tpu/native/runtime.py).

The library is the repository's `native/src/umfa_runtime.cpp` (C ABI in
`native/include/umfa_ffi.h`): process-global dispatch statistics, latency
bookkeeping and CPU reference quantizers. The device path does not use it.

The port builds its own copy at first use, with the host C++ compiler
(`$CXX`, else `g++`) and the flags of `native/Makefile`, into the port's
`_build/` (git-ignored), under a name that carries a hash of the sources,
the flags and the compiler, built to a temporary name and renamed into
place (several test workers may build at once). It never loads the
library that `native/Makefile` builds into `native/build/`: two packages
that `dlopen` one path in one process share one set of counters, and the
port's counters must stay its own.

`available()` answers False when the library cannot be built or loaded;
every other call raises, naming the compiler and its log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_ROUTE_NAMES = (
    "total",
    "fused_fwd",
    "fused_autograd",
    "quantized_fwd",
    "quantized_autograd",
    "rope_fused",
    "naive_fallback",
    "mask_all_true_skipped",
    "window_auto_tiled",
)
_ROUTE_IDS = {name: i for i, name in enumerate(_ROUTE_NAMES)}

_PKG = Path(__file__).resolve().parent.parent
_NATIVE = _PKG.parent / "native"
_SRC = _NATIVE / "src" / "umfa_runtime.cpp"
_HEADER = _NATIVE / "include" / "umfa_ffi.h"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS, then its include directory and -shared.
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[RuntimeError] = None
_load_lock = threading.Lock()


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def lib_path() -> Path:
    """Where the port's copy of the library is built: a name hashed from
    the sources, the flags and the compiler."""
    h = hashlib.sha256(" ".join(_compiler() + list(CXXFLAGS)).encode())
    for src in (_SRC, _HEADER):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libumfa_runtime-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*_compiler(), *CXXFLAGS, f"-I{_HEADER.parent}", "-shared", "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native runtime build: the C++ compiler {cmd[0]!r} did not run: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial .so


def _declare(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    lib.umfa_version.restype = ctypes.c_char_p
    lib.umfa_version.argtypes = []
    lib.umfa_record_dispatch.argtypes = [ctypes.c_int]
    lib.umfa_record_dispatch.restype = None
    lib.umfa_get_dispatch_stats.argtypes = [ctypes.POINTER(u64 * len(_ROUTE_NAMES))]
    lib.umfa_get_dispatch_stats.restype = None
    lib.umfa_reset_dispatch_stats.argtypes = []
    lib.umfa_reset_dispatch_stats.restype = None
    lib.umfa_record_latency_ns.argtypes = [u64]
    lib.umfa_record_latency_ns.restype = None
    lib.umfa_get_last_latency_ns.argtypes = []
    lib.umfa_get_last_latency_ns.restype = u64
    lib.umfa_get_mean_latency_ns.argtypes = []
    lib.umfa_get_mean_latency_ns.restype = ctypes.c_double
    f32p, i8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8)
    lib.umfa_quantize_int8_rowwise.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, i8p, f32p]
    lib.umfa_quantize_int8_rowwise.restype = ctypes.c_int


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError (the
    same one on every later call) if it cannot be built or loaded."""
    global _lib, _error
    with _load_lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _error = e if isinstance(e, RuntimeError) else RuntimeError(
                f"native runtime: cannot load the library: {e}")
            raise _error from None
        _declare(lib)
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
    except RuntimeError:
        return False
    return True


def version() -> str:
    return _load().umfa_version().decode()


def record_dispatch(route: str) -> None:
    _load().umfa_record_dispatch(_ROUTE_IDS.get(route, 0))


def get_dispatch_stats() -> Dict[str, int]:
    buf = (ctypes.c_uint64 * len(_ROUTE_NAMES))()
    _load().umfa_get_dispatch_stats(ctypes.byref(buf))
    return {name: int(buf[i]) for i, name in enumerate(_ROUTE_NAMES)}


def reset_dispatch_stats() -> None:
    _load().umfa_reset_dispatch_stats()


def record_latency_ns(ns: int) -> None:
    _load().umfa_record_latency_ns(int(ns))


def get_last_latency_ns() -> int:
    return int(_load().umfa_get_last_latency_ns())


def get_mean_latency_ns() -> float:
    return float(_load().umfa_get_mean_latency_ns())


def quantize_int8_rowwise(x):
    """CPU reference quantizer: row-wise symmetric INT8 of a float array
    (numpy, or a tensor, which is copied to the host). Returns (codes int8
    of x's shape, scales float32 of x.shape[:-1]) as numpy arrays."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu", copy=False).float().numpy()
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    cols = x.shape[-1]
    rows = x.size // cols if cols else 0
    out = np.empty((rows, cols), np.int8)
    scales = np.empty((rows,), np.float32)
    rc = lib.umfa_quantize_int8_rowwise(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"umfa_quantize_int8_rowwise failed: {rc}")
    return out.reshape(x.shape), scales.reshape(x.shape[:-1])

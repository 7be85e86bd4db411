"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled at first use with ``nvcc`` into one shared
library with a plain C interface, loaded with ctypes.  The library lands in
``impop_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs at import time; a missing ``nvcc`` or a failed build
raises.  The build never uses ``--use_fast_math``: an approximate divide
would move identity values across the grouping threshold.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["load_library", "nvcc_path", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found ($CUDA_HOME, /usr/local/cuda or PATH): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.impop_window_stats_smem.argtypes = [_I, _I]
    lib.impop_window_stats_smem.restype = ctypes.c_size_t
    lib.impop_window_stats.argtypes = (
        [_P] * 8 + [_F] + [_I] * 10 + [_P] * 8)
    lib.impop_window_stats.restype = _I
    lib.impop_seed_peel.argtypes = [_P] * 4 + [_F] + [_I] * 3 + [_P] * 3
    lib.impop_seed_peel.restype = _I
    lib.impop_error_string.argtypes = [_I]
    lib.impop_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        target = os.path.join(_BUILD, f"impop_kernels-{_digest(sources)}.so")
        if not os.path.exists(target):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    "nvcc failed (" + " ".join(cmd) + "):\n"
                    + proc.stdout + proc.stderr)
            os.replace(tmp, target)
        _lib = _bind(ctypes.CDLL(target))
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.impop_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")

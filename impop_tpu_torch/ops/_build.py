"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes.  The library lands in
``impop_tpu_torch/_build/`` under a name keyed by a hash of the sources,
the headers they share and the flags, so a changed source rebuilds and an
unchanged one loads at once.
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

__all__ = ["load_library", "nvcc_path", "check", "u8_mask",
           "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

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
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for path in sources + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.impop_window_stats.argtypes = (
        [_P] * 8 + [_F] + [_I] * 10 + [_P] * 10)
    lib.impop_window_stats.restype = _I
    lib.impop_seed_peel.argtypes = [_P] * 4 + [_F] + [_I] * 3 + [_P] * 4
    lib.impop_seed_peel.restype = _I
    lib.impop_ehh_area.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 6
    lib.impop_ehh_area.restype = _I
    lib.impop_weighted_identity.argtypes = [_P] * 5 + [_I] * 5 + [_P] * 4
    lib.impop_weighted_identity.restype = _I
    lib.impop_pairwise_identity.argtypes = [_P] * 4 + [_I] * 5 + [_P] * 4
    lib.impop_pairwise_identity.restype = _I
    lib.impop_identity_group.argtypes = (
        [_P] * 5 + [_F] + [_I] * 4 + [_P] * 8)
    lib.impop_identity_group.restype = _I
    lib.impop_masked_pair_sums.argtypes = [_P] * 4 + [_I] * 5 + [_P] * 4
    lib.impop_masked_pair_sums.restype = _I
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
            with tempfile.TemporaryDirectory(dir=_BUILD) as work:
                _compile(sources, work, target)
        _lib = _bind(ctypes.CDLL(target))
        return _lib


def _compile(sources: list[str], work: str, target: str) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link;
    the library is renamed into place only when every step succeeded."""
    nvcc = nvcc_path()
    objs = [os.path.join(work, os.path.basename(src) + ".o")
            for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = os.path.join(work, "lib.so")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed (" + " ".join(cmd) + "):\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, target)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.impop_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def u8_mask(t, what: str, name: str, shape: tuple):
    """A bool/uint8 mask argument of kernel ``what`` as a contiguous uint8
    tensor of exactly ``shape``; raises on anything else."""
    import torch

    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: {name} must be bool or uint8, got "
                         f"{t.dtype}")
    return t.contiguous().view(torch.uint8)

"""The port never loads JAX: importing every module of impop_tpu_torch in a
fresh interpreter must leave ``jax`` out of ``sys.modules`` (the machine
with the card has no JAX at all).  Also: the device helper never moves to
the CPU by itself, and nothing builds a kernel at import time."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "impop_tpu_torch", "impop_tpu_torch.cli", "impop_tpu_torch.device",
    "impop_tpu_torch.hostio", "impop_tpu_torch.scanstep",
    "impop_tpu_torch.ops._build", "impop_tpu_torch.ops.ehhdeath",
    "impop_tpu_torch.ops.idgroup", "impop_tpu_torch.ops.pairdiff",
    "impop_tpu_torch.ops.panelquad", "impop_tpu_torch.ops.seedpeel",
    "impop_tpu_torch.ops.windowstat", "impop_tpu_torch.parallel",
    "impop_tpu_torch.parallel.scan", "impop_tpu_torch.runtime.batcher",
    "impop_tpu_torch.runtime.journal", "impop_tpu_torch.runtime.profiling",
    "impop_tpu_torch.runtime.sitestream", "impop_tpu_torch.stats.allele",
    "impop_tpu_torch.stats.api", "impop_tpu_torch.stats.diversity",
    "impop_tpu_torch.stats.ehh", "impop_tpu_torch.stats.fst",
    "impop_tpu_torch.stats.grouping", "impop_tpu_torch.stats.panelstats",
    "impop_tpu_torch.stats.pi", "impop_tpu_torch.stats.tajima",
    "impop_tpu_torch.stats.types",
]


def test_port_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import impop_tpu_torch.ops._build as b\n"
            + "assert b._lib is None, 'kernel library loaded at import'\n"
            + "bad = sorted(m for m in sys.modules"
              " if m == 'jax' or m.startswith('jax.'))\n"
            + "print(bad)\n"
            + "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device_never_falls_back():
    from impop_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")

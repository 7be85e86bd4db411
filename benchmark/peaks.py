"""The NVIDIA H100's published peaks and a kernel's share of its roofline.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
(int32: 64 lanes per SM, half the float32 rate).  A card set below 700 W
runs slower under load, so every share is stated with the card's name and
power limit (``nvidia-smi``).
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional

__all__ = ["BYTES_PER_S", "PEAK", "least_time", "card", "roofline_share"]

BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "int32": 33.5e12}


def least_time(ops: Dict[str, float], n_bytes: float):
    """(seconds, bound): the larger of the bytes over the memory rate and
    each type's operations over its peak; bound names which."""
    t_bytes = n_bytes / BYTES_PER_S
    t_ops, kind = 0.0, None
    for k, n in ops.items():
        if n / PEAK[k] > t_ops:
            t_ops, kind = n / PEAK[k], k
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, f"operations ({kind})"


def card() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` prints
    it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def roofline_share(run, kernel: str) -> Optional[dict]:
    """A kernel's share of its roofline in the traced window: the least
    time of the work its launches did (``benchmark/rooflines/<kernel>.py``)
    over their device time, in %; None where the kernel did not run."""
    mod = run.spec.roofline(kernel)
    t_dev = run.trace.kernel_s(mod.KERNELS)
    if t_dev <= 0:
        return None
    ops, n_bytes = mod.work(run)
    t_min, bound = least_time(ops, n_bytes)
    return {"value": 100.0 * t_min / t_dev, "bound": bound,
            "card": run.card}

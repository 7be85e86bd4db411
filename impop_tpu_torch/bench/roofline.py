"""The NVIDIA H100's peak rates, the least time a function could take on
it, and the card's name and power limit (one table for ``chip_smoke.py``
and the measurement entry points of ``impop_tpu_torch.bench``)."""
from __future__ import annotations

import subprocess

__all__ = ["H100_BYTES_PER_S", "H100_PEAK", "nbytes", "bound",
           "nvidia_smi_line"]

# NVIDIA H100 SXM data sheet, dense: memory rate and peak rates by type
# (int32: 64 lanes per SM, half the fp32 rate)
H100_BYTES_PER_S = 3.35e12
H100_PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12,
             "int32": 33.5e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, **ops) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and each type's
    operations over its peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = max((n / H100_PEAK[k] for k, n in ops.items()), default=0.0)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nvidia_smi_line() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it;
    raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]

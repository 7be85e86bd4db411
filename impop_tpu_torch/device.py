"""Explicit device resolution.

Every function of the port takes its device from its tensors or from an
explicit argument; nothing here keeps a current device.  Asking for CUDA on
a machine without it raises: the port never moves to the CPU by itself.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:K"`` or ``"cpu"`` -> a torch.device.

    For CUDA this also turns TF32 off for float32 matrix products: the
    plain reductions carry real (1 - sim) values and must stay in full
    float32, as the reference pins ``Precision.HIGHEST`` for them.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False (use --device cpu for the plain PyTorch path)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev

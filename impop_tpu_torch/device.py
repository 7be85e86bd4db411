"""Explicit device resolution.

Every function of the port takes its device from its tensors or from an
explicit argument; nothing here keeps a current device.  Asking for CUDA on
a machine without it raises: the port never moves to the CPU by itself.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "local_devices", "on_device"]


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


def local_devices(name: str | torch.device) -> list[torch.device]:
    """The devices a command runs on: ``"cuda"`` is every local GPU
    (``cuda:0`` .. ``cuda:K-1``), ``"cuda:K"`` that one, ``"cpu"`` the
    CPU."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [dev]


def on_device(dev: torch.device):
    """A context in which CUDA work is queued on ``dev`` (kernels launch on
    the calling thread's current device); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()

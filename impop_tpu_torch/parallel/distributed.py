"""Multi-host scan coordination (counterpart of
:mod:`impop_tpu.parallel.distributed`).

Windows are independent, so hosts share nothing but the window list: each
process takes the contiguous slice :func:`host_window_range` gives it,
scans it on its local devices, and writes ``<file>.partK`` outputs that
``merge-parts`` joins afterwards.  No tensor crosses hosts.
``torch.distributed`` (gloo) gives the rank, the world size and one closing
barrier; NCCL is not needed.

The process group reads torchrun's environment (``init_method="env://"``)
where the JAX package reads ``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``:

    torchrun --nnodes 2 --nproc-per-node 1 --rdzv-endpoint host0:29500 \\
        -m impop_tpu_torch.cli scan ... --distributed

or, without torchrun, ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` (and ``LOCAL_RANK``) set by hand in each process.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch

from impop_tpu_torch.device import local_devices

__all__ = ["maybe_initialize", "host_window_range", "local_rank",
           "process_devices", "finalize"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def maybe_initialize(enabled: bool) -> Tuple[int, int]:
    """Join the gloo process group from the environment when enabled.

    Returns (rank, world size); (0, 1) when not enabled."""
    import torch.distributed as dist

    if not enabled:
        return 0, 1
    if not dist.is_initialized():
        missing = [k for k in _ENV if not os.environ.get(k)]
        if missing:
            raise SystemExit(
                "error: --distributed needs " + ", ".join(missing)
                + " in the environment (torchrun sets them)")
        if (os.environ["MASTER_ADDR"] in _LOOPBACK
                and not os.environ.get("GLOO_SOCKET_IFNAME")):
            # ranks of one host meeting at a loopback address
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        dist.init_process_group("gloo", init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def host_window_range(n_windows: int, process_index: int,
                      process_count: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) slice of the window list owned by this host."""
    per_host = (n_windows + process_count - 1) // process_count
    lo = min(process_index * per_host, n_windows)
    hi = min(lo + per_host, n_windows)
    return lo, hi


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_devices(name: str) -> List[torch.device]:
    """The devices of this process: ``local_devices(name)``, except that
    ``--device cuda`` under a launcher that starts several processes per
    host (``LOCAL_WORLD_SIZE`` > 1) gives each its own ``cuda:LOCAL_RANK``.
    One process per host takes every local GPU, as the JAX scan takes
    every local chip."""
    devs = local_devices(name)
    if (len(devs) > 1 and str(name) == "cuda"
            and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1):
        return [devs[local_rank()]]
    return devs


def finalize() -> None:
    """The closing barrier of a distributed run (every rank has written
    its parts before any leaves), then the group is taken down."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()

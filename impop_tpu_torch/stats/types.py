"""Padded window tiles (port of :mod:`impop_tpu.stats.types`).

Every estimator of :mod:`impop_tpu_torch.stats` takes one window's
similarity as a fixed-shape [N, N] matrix with masks: the reference's
ragged dict of pairs (pica2.py:29) becomes a masked rectangle.  The
builders here make torch tensors on the device they are given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["SimTile", "pad_tile", "sim_tile_from_matrix", "mask_from_names"]


class SimTile(NamedTuple):
    """One window's pairwise identity, padded to capacity N.

    sim:     [N, N] float32, symmetric, diagonal 1, 0 where absent
    present: [N, N] bool, True where the pair has data (diagonal True)
    member:  [N] bool, True for real rows
    """

    sim: torch.Tensor
    present: torch.Tensor
    member: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.member.shape[-1]


def pad_tile(sim: np.ndarray, present: np.ndarray, capacity: int,
             member: Optional[np.ndarray] = None, *,
             device: str | torch.device = "cpu") -> SimTile:
    """Pad host [n, n] arrays out to capacity N as a SimTile on
    ``device``."""
    n = sim.shape[0]
    if n > capacity:
        raise ValueError(f"window has {n} haplotypes > tile capacity "
                         f"{capacity}")
    sim_p = np.zeros((capacity, capacity), dtype=np.float32)
    pres_p = np.zeros((capacity, capacity), dtype=bool)
    memb_p = np.zeros(capacity, dtype=bool)
    sim_p[:n, :n] = sim
    pres_p[:n, :n] = present
    memb_p[:n] = True if member is None else member
    return SimTile(*(torch.from_numpy(a).to(device)
                     for a in (sim_p, pres_p, memb_p)))


def sim_tile_from_matrix(mat, capacity: Optional[int] = None, *,
                         device: str | torch.device = "cpu") -> SimTile:
    """A SimTile from an ``impop_tpu.io.SimilarityMatrix``.  Decimal
    rounding, if any, is applied on the host in float64 before this
    (``SimilarityMatrix.rounded``)."""
    cap = capacity if capacity is not None else mat.n
    return pad_tile(mat.sim.astype(np.float32), mat.present, cap,
                    device=device)


def mask_from_names(mat, names: Sequence[str], capacity: int, *,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Panel membership [capacity] bool of the named rows of ``mat``."""
    mask = np.zeros(capacity, dtype=bool)
    idx = mat.index()
    for name in names:
        i = idx.get(name)
        if i is not None:
            mask[i] = True
    return torch.from_numpy(mask).to(device)

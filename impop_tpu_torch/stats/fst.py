"""Hudson's Fst (the scan's part of :mod:`impop_tpu.stats.fst`).

- :func:`_assemble` — the six-column result from (πA, πB, Dxy).
- :func:`hudson_fst_grouped_pairs` — hud.py ``-m grouped`` with exact
  first-found representative pairs, for Q pairs of one window; the scan
  re-runs windows flagged by ``seed_risk`` through it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.stats.grouping import (first_pair_winner,
                                            greedy_group_panels, group_sizes)

__all__ = ["FstResult", "hudson_fst_grouped_pairs"]


class FstResult(NamedTuple):
    """Raw sums (not per-site); divide by the window length for the
    per-site table values."""

    fst: torch.Tensor
    pi_a: torch.Tensor
    pi_b: torch.Tensor
    pi_xy: torch.Tensor
    dxy: torch.Tensor
    da: torch.Tensor


def _assemble(pi_a, pi_b, dxy) -> FstResult:
    pi_xy = 0.5 * (pi_a + pi_b)
    pos = dxy > 0
    fst = torch.where(pos, (dxy - pi_xy) / torch.where(pos, dxy, 1.0), 0.0)
    return FstResult(fst, pi_a, pi_b, pi_xy, dxy, dxy - pi_xy)


def hudson_fst_grouped_pairs(sim: torch.Tensor, present: torch.Tensor,
                             masks_a: torch.Tensor, masks_b: torch.Tensor,
                             threshold) -> FstResult:
    """Grouped Hudson Fst for Q overlap-stripped pair masks of one window.

    All 2Q population masks share one grouping pass.  Within-population
    diversity: Σ over first-found representative pairs of
    2·f_a·f_b·(1 - sim), times the Bessel factor n/(n-1).  Dxy: cross
    group weights |gA|·|gB| / (nA·nB) on first-found cross pairs, no Bessel.

    Args: sim/present [N, N], masks_a/masks_b [Q, N] bool.
    Returns [Q]-shaped fields.
    """
    q, n_cap = masks_a.shape
    all_masks = torch.cat([masks_a, masks_b], dim=0)          # [2Q, N]
    member = all_masks.any(dim=0)
    gid = greedy_group_panels(sim, present, member, all_masks, threshold)
    sizes = group_sizes(gid, all_masks)
    n = all_masks.sum(dim=1, dtype=torch.float32)
    idx = torch.clamp(gid, 0, n_cap - 1).to(torch.int64)
    size_of = torch.gather(sizes, 1, idx).to(torch.float32)   # [2Q, N]
    one_minus = 1.0 - sim

    winner = first_pair_winner(present, all_masks, gid, gid, ordered=False)
    freq = size_of / torch.clamp(n, min=1.0)[:, None]
    terms = torch.where(
        winner, 2.0 * freq[:, :, None] * freq[:, None, :] * one_minus, 0.0)
    total = terms.sum(dim=(-1, -2))
    divs = torch.where(n > 1, total * n / torch.clamp(n - 1.0, min=1.0), 0.0)

    winner_x = first_pair_winner(present, masks_a, gid[:q], gid[q:],
                                 member_col=masks_b, ordered=True)
    na, nb = n[:q], n[q:]
    weight = (size_of[:q, :, None] * size_of[q:, None, :]
              / torch.clamp(na * nb, min=1.0)[:, None, None])
    dxy = torch.where(winner_x, weight * one_minus, 0.0).sum(dim=(-1, -2))
    return _assemble(divs[:q], divs[q:], dxy)

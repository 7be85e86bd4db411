"""Hudson's Fst and the 3-π Fst (port of :mod:`impop_tpu.stats.fst`).

1. :func:`hudson_fst_direct` / :func:`hudson_fst_direct_pairs` — Fst =
   (Dxy − πxy) / Dxy with direct pairwise means (h-fst.py:173-249, hud.py
   ``-m direct``), πxy = ½(πA + πB).
2. :func:`hudson_fst_grouped` / :func:`hudson_fst_grouped_pairs` — hud.py
   ``-m grouped`` (hud.py:204-263): within-population grouped diversities,
   Dxy from cross-population group weights |gA|·|gB| / (nA·nB) on
   first-found representative pairs.
3. :func:`fst_3pi` — run_fst_impg.sh:199-218, NaN where πC = 0.

Leading axes are batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.ops.panelquad import masked_pair_sums
from impop_tpu_torch.stats.grouping import (first_pair_winner,
                                            greedy_group_panels, group_sizes)

__all__ = ["FstResult", "hudson_fst_direct", "hudson_fst_direct_pairs",
           "hudson_fst_grouped", "hudson_fst_grouped_pairs", "fst_3pi"]


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


def _one_pair(pairs_fn, sim, present, mask_a, mask_b, *rest) -> FstResult:
    """A pairs function called with Q = 1, its [..., 1] fields squeezed."""
    res = pairs_fn(sim, present, mask_a[..., None, :], mask_b[..., None, :],
                   *rest)
    return FstResult(*(f[..., 0] for f in res))


def hudson_fst_direct(sim: torch.Tensor, present: torch.Tensor,
                      mask_a: torch.Tensor, mask_b: torch.Tensor
                      ) -> FstResult:
    """Direct Hudson Fst of two disjoint masks [..., N] (the reference
    strips the overlap first, h-fst.py:181-185): one pair of
    :func:`hudson_fst_direct_pairs`."""
    return _one_pair(hudson_fst_direct_pairs, sim, present, mask_a, mask_b)


def hudson_fst_direct_pairs(sim: torch.Tensor, present: torch.Tensor,
                            masks_a: torch.Tensor, masks_b: torch.Tensor
                            ) -> FstResult:
    """:func:`hudson_fst_direct` for Q overlap-stripped pair masks
    [..., Q, N] of a window: the four products a·div, a·pres, b·div and
    b·pres are one ``masked_pair_sums`` call on the [..., 2Q, N] stack
    [a; b], so sim is read once for all pairs.  Fields are [..., Q]."""
    q = masks_a.shape[-2]
    ab = torch.cat([masks_a, masks_b], dim=-2).to(torch.float32)
    yd, yp = masked_pair_sums(sim, present, ab, ab)
    a, b = ab[..., :q, :], ab[..., q:, :]

    def rowdot(x, y):
        return (x * y).sum(dim=-1)

    def mean(total, count):
        return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                           0.0)

    yd_a, yp_a = yd[..., :q, :], yp[..., :q, :]
    yd_b, yp_b = yd[..., q:, :], yp[..., q:, :]
    pi_a = mean(rowdot(yd_a, a) * 0.5, rowdot(yp_a, a) * 0.5)
    pi_b = mean(rowdot(yd_b, b) * 0.5, rowdot(yp_b, b) * 0.5)
    dxy = mean(rowdot(yd_a, b), rowdot(yp_a, b))
    return _assemble(pi_a, pi_b, dxy)


def _cross_dxy(sim, present, mask_a, mask_b, gid_a, gid_b, size_of_a,
               size_of_b, n_a, n_b):
    """Grouped Dxy (hud.py:235-263): Σ over first-found cross pairs of
    |gA|·|gB| / (nA·nB) · (1 − sim), no Bessel factor."""
    winner = first_pair_winner(present, mask_a, gid_a, gid_b,
                               member_col=mask_b, ordered=True)
    weight = (size_of_a[..., :, None] * size_of_b[..., None, :]
              / torch.clamp(n_a * n_b, min=1.0)[..., None, None])
    return torch.where(winner, weight * (1.0 - sim), 0.0).sum(dim=(-2, -1))


def _size_of(gid, sizes):
    """|group(i)| for every row i, as float32."""
    idx = torch.clamp(gid, 0, gid.shape[-1] - 1).to(torch.int64)
    return torch.gather(sizes, -1, idx).to(torch.float32)


def hudson_fst_grouped(sim: torch.Tensor, present: torch.Tensor,
                       mask_a: torch.Tensor, mask_b: torch.Tensor,
                       threshold) -> FstResult:
    """Grouped Hudson Fst of two masks [..., N]: one pair of
    :func:`hudson_fst_grouped_pairs`."""
    return _one_pair(hudson_fst_grouped_pairs, sim, present, mask_a, mask_b,
                     threshold)


def hudson_fst_grouped_pairs(sim: torch.Tensor, present: torch.Tensor,
                             masks_a: torch.Tensor, masks_b: torch.Tensor,
                             threshold) -> FstResult:
    """Grouped Hudson Fst (hud.py:204-263) for Q overlap-stripped pair
    masks of a window.

    All 2Q population masks share one grouping pass.  Within-population
    diversity: Σ over first-found representative pairs of
    2·f_a·f_b·(1 - sim), times the Bessel factor n/(n-1).  Dxy: cross
    group weights |gA|·|gB| / (nA·nB) on first-found cross pairs, no Bessel.

    Args: sim/present [..., N, N], masks_a/masks_b [..., Q, N] bool.
    Returns [..., Q]-shaped fields.  The first-pair search holds several
    [..., 2Q, N, N] temporaries.
    """
    f32 = torch.float32
    q = masks_a.shape[-2]
    all_masks = torch.cat([masks_a, masks_b], dim=-2)         # [..., 2Q, N]
    member = all_masks.any(dim=-2)
    gid = greedy_group_panels(sim, present, member, all_masks, threshold)
    n = all_masks.sum(dim=-1, dtype=f32)
    size_of = _size_of(gid, group_sizes(gid, all_masks))      # [..., 2Q, N]
    sim_r, pres_r = sim[..., None, :, :], present[..., None, :, :]

    winner = first_pair_winner(pres_r, all_masks, gid, gid, ordered=False)
    freq = size_of / torch.clamp(n, min=1.0)[..., None]
    terms = torch.where(winner, 2.0 * freq[..., :, None] * freq[..., None, :]
                        * (1.0 - sim_r), 0.0)
    total = terms.sum(dim=(-2, -1))
    divs = torch.where(n > 1, total * n / torch.clamp(n - 1.0, min=1.0), 0.0)

    dxy = _cross_dxy(sim_r, pres_r, masks_a, masks_b, gid[..., :q, :],
                     gid[..., q:, :], size_of[..., :q, :],
                     size_of[..., q:, :], n[..., :q], n[..., q:])
    return _assemble(divs[..., :q], divs[..., q:], dxy)


def fst_3pi(pi_a, pi_b, pi_c) -> torch.Tensor:
    """(πC − ½(πA + πB)) / πC, NaN where πC = 0 (the CLI prints NA).
    The three π share one scale, raw or per site."""
    pi_ab = 0.5 * (pi_a + pi_b)
    nz = pi_c != 0
    return torch.where(nz, (pi_c - pi_ab) / torch.where(nz, pi_c, 1.0),
                       torch.nan)

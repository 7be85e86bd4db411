"""Direct (ungrouped) mean pairwise diversity (port of
:mod:`impop_tpu.stats.diversity`).

The reference's ``calculate_diversity`` (h-fst.py:130-171) averages
(1 - similarity) over all pairs with data, within one set or across two,
and counts the pairs without data as missing.  Here the value sum and the
pair count are the two masked products of ``ops.panelquad.masked_pair_sums``
(the masked-sums kernel on CUDA tensors) and a row-dot.  Leading axes are
batch axes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from impop_tpu_torch.ops.panelquad import masked_pair_sums

__all__ = ["DiversityResult", "direct_diversity"]


class DiversityResult(NamedTuple):
    mean: torch.Tensor     # [...] f32 average (1 - sim); 0 without pairs
    count: torch.Tensor    # [...] int32 pairs with data
    missing: torch.Tensor  # [...] int32 pairs without data


def direct_diversity(sim: torch.Tensor, present: torch.Tensor,
                     mask_a: torch.Tensor,
                     mask_b: Optional[torch.Tensor] = None
                     ) -> DiversityResult:
    """Mean pairwise (1 - sim) within mask_a, or between mask_a and mask_b.

    The within case averages over unordered pairs i < j of mask_a, the
    between case over the full cross product (the reference strips the
    overlap first, h-fst.py:181-185, so the caller's masks must be disjoint
    for between-set parity).  Sums and counts are float32 (no TF32).

    Args: sim/present [..., N, N], mask_a/mask_b [..., N] bool.
    """
    a = mask_a.to(torch.float32)
    yd, yp = masked_pair_sums(sim, present, a[..., None, :], a[..., None, :])
    if mask_b is None:
        total = (yd[..., 0, :] * a).sum(dim=-1) * 0.5
        count = (yp[..., 0, :] * a).sum(dim=-1) * 0.5
        n_a = a.sum(dim=-1)
        all_pairs = n_a * (n_a - 1.0) * 0.5
    else:
        b = mask_b.to(torch.float32)
        total = (yd[..., 0, :] * b).sum(dim=-1)
        count = (yp[..., 0, :] * b).sum(dim=-1)
        all_pairs = a.sum(dim=-1) * b.sum(dim=-1)
    mean = torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)
    return DiversityResult(mean, torch.round(count).to(torch.int32),
                           torch.round(all_pairs - count).to(torch.int32))

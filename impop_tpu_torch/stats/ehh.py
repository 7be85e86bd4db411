"""Extended Haplotype Homozygosity decay areas for the scan (port of
``impop_tpu.stats.ehh.ehh_area_dynamic``).

The area under a focal site's bidirectional EHH decay curve is
Σ_pairs steps(pair) / C(n_c, 2): a pair of carriers of one allele adds one
step for every active site, walking away from the focal column, that it
stays identical on.  Steps count ACTIVE sites only, so the result does not
depend on the tile's padding capacity (a window may be padded to different
caps in different batches).
"""
from __future__ import annotations

import torch

from impop_tpu_torch.ops.ehhdeath import ehh_area

__all__ = ["ehh_area_dynamic"]


def ehh_area_dynamic(geno: torch.Tensor, member: torch.Tensor,
                     site_mask: torch.Tensor, focal: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional EHH decay areas for alleles (0, 1) at each window's
    focal column.

    ``geno`` is binarised as (call == 1), so a missing call counts as
    allele 0; carriers of allele a are members whose raw focal call
    binarises to a.  The step sums come from ``ops.ehhdeath.ehh_area`` in
    int64 and are divided by max(C(n_c, 2), 1) in float32.

    Args:
      geno: [..., N, S] int8; member: [..., N] bool; site_mask: [..., S]
        bool; focal: [...] int focal column index.
    Returns (area [..., 2] f32, carriers [..., 2] int32).
    """
    sums, carr = ehh_area(geno, member, site_mask, focal)
    n_c = carr.to(torch.float32)
    denom = torch.clamp(n_c * (n_c - 1.0) * 0.5, min=1.0)
    return sums.to(torch.float32) / denom, carr

"""Batched Tajima's D from allele tiles (port of
``impop_tpu.parallel.scan.TajdBatchResult`` and
``batch_tajd_from_alleles``).

The JAX package vmaps one window, then one panel; here the window axis W
and the panel axis P are batch dimensions: one identity call for all
windows (the unit-weight identity kernel on CUDA tensors) and one grouped-π
call for all (window, panel) pairs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                          segregating_sites)
from impop_tpu_torch.stats.pi import pi_grouped
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["TajdBatchResult", "batch_tajd_from_alleles"]


class TajdBatchResult(NamedTuple):
    pi: torch.Tensor   # [W, P] pica2-grouped π per site (run_tajd.sh:174)
    s: torch.Tensor    # [W] int32 segregating sites over the whole window
    n: torch.Tensor    # [W, P] f32 panel sizes
    d: torch.Tensor    # [W, P] f32 Tajima's D


def batch_tajd_from_alleles(geno, member, site_mask, panels, lengths,
                            threshold, num_alleles: int = 2
                            ) -> TajdBatchResult:
    """run_tajd.sh for every (window, panel): one allele tile feeds both
    the S branch and the π branch.

    Args: geno [W, N, S] int8, member [W, N], site_mask [W, S], panels
    [W, P, N] bool, lengths [W] (anything ``torch.as_tensor`` takes),
    threshold a float.  As in the reference, D takes the per-site π with
    the absolute S.
    """
    dev = geno.device
    lengths = torch.as_tensor(lengths, dtype=torch.float32, device=dev)
    sim, present = identity_from_alleles(geno, member, site_mask, lengths,
                                         num_alleles)
    s_count = segregating_sites(geno, member, site_mask)
    p_count = panels.shape[-2]
    res = pi_grouped(sim[:, None].expand(-1, p_count, -1, -1),
                     present[:, None].expand(-1, p_count, -1, -1),
                     member[:, None, :] & panels, threshold)
    pi_site = res.pi / torch.clamp(lengths, min=1.0)[:, None]
    d = tajimas_d(res.n, s_count.to(torch.float32)[:, None], pi_site)
    return TajdBatchResult(pi_site, s_count, res.n, d)

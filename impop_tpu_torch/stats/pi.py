"""Nucleotide diversity with pica2 semantics (port of
:func:`impop_tpu.stats.pi.pi_grouped`; ``pi_grouped_panels`` and
``grouped_diversity`` come with the ``pi`` / ``hud`` CLIs).

    π = n / (n − 1) · Σ_{group pairs a < b with data} 2 (1 − s_ab) f_a f_b

with greedy one-hop groups, s_ab the similarity of the two seeds and f the
group frequencies (pica2.py:94-169).  Leading axes are batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.stats.grouping import greedy_group, rep_weights

__all__ = ["PiResult", "pi_grouped"]


class PiResult(NamedTuple):
    pi: torch.Tensor             # [...] f32, the statistic (not per site)
    n: torch.Tensor              # [...] f32 member haplotypes
    num_groups: torch.Tensor     # [...] int32 allele classes
    pairs_used: torch.Tensor     # [...] int32 group pairs with data
    pairs_missing: torch.Tensor  # [...] int32 group pairs without data

    def per_site(self, length) -> torch.Tensor:
        return self.pi / length


def pi_grouped(sim: torch.Tensor, present: torch.Tensor, member: torch.Tensor,
               threshold) -> PiResult:
    """π over sim/present [..., N, N] and member [..., N].

    The quadratic form wᵀ((1 − sim) ⊙ mask) w is an elementwise product
    and two float32 sums over the last axis (no TF32 on any device, and the
    same summation order for any number of leading axes).  0 when n <= 1
    or no group pair has data."""
    gid = greedy_group(sim, present, member, threshold)
    w, n = rep_weights(gid, member)
    is_rep = w > 0
    n_cap = member.shape[-1]
    offdiag = ~torch.eye(n_cap, dtype=torch.bool, device=sim.device)
    pair_mask = present & offdiag
    contrib = torch.where(pair_mask, 1.0 - sim, 0.0)
    quad = (w * (contrib * w[..., None, :]).sum(dim=-1)).sum(dim=-1)
    num_groups = is_rep.sum(dim=-1, dtype=torch.int32)
    rep_pair = is_rep[..., :, None] & is_rep[..., None, :] & offdiag
    pairs_used = (rep_pair & present).sum(dim=(-2, -1),
                                          dtype=torch.int32) // 2
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pi = torch.where((n > 1) & (pairs_used > 0),
                     n / torch.clamp(n - 1.0, min=1.0) * quad, 0.0)
    return PiResult(pi, n, num_groups, pairs_used, pairs_total - pairs_used)

"""Nucleotide diversity (port of :mod:`impop_tpu.stats.pi`).

- :func:`pi_grouped` / :func:`pi_grouped_panels` — pica2 semantics
  (pica2.py:94-169):

      π = n / (n − 1) · Σ_{group pairs a < b with data} 2 (1 − s_ab) f_a f_b

  with greedy one-hop groups, s_ab the similarity of the two seeds and f
  the group frequencies.
- :func:`grouped_diversity` — hud.py grouped semantics (hud.py:100-128):
  the same groups, each group pair represented by its first present
  element pair.

Leading axes are batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.ops.panelquad import masked_pair_sums
from impop_tpu_torch.stats.grouping import (first_pair_winner, greedy_group,
                                            greedy_group_panels, group_sizes,
                                            rep_weights)

__all__ = ["PiResult", "pi_grouped", "pi_grouped_panels",
           "grouped_diversity"]


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


def pi_grouped_panels(sim: torch.Tensor, present: torch.Tensor,
                      member: torch.Tensor, pmasks: torch.Tensor,
                      threshold) -> PiResult:
    """:func:`pi_grouped` for P panels of one window in one pass.

    The P panels share one grouping call (``greedy_group_panels``: the
    seed-peel kernel on CUDA tensors) and one ``masked_pair_sums`` call
    (the masked-sums kernel on CUDA tensors): ``Yd = w·((1 − sim) ⊙ mask)``
    gives the quadratic forms and ``Yp = rep·mask`` the group pairs with
    data, both fp32.

    Args: sim/present [..., N, N], member [..., N], pmasks [..., P, N].
    Returns PiResult with [..., P] fields.
    """
    f32 = torch.float32
    gid = greedy_group_panels(sim, present, member, pmasks, threshold)
    pm = pmasks & member[..., None, :]
    n = pm.sum(dim=-1, dtype=f32)
    sizes = group_sizes(gid, pm)
    is_rep = sizes > 0
    w = torch.where(is_rep, sizes.to(f32) / torch.clamp(n, min=1.0)[..., None],
                    0.0)
    rep_f = is_rep.to(f32)
    yd, yp = masked_pair_sums(sim, present, w, rep_f)
    quad = (yd * w).sum(dim=-1)
    num_groups = is_rep.sum(dim=-1, dtype=torch.int32)
    pairs_used = torch.round((yp * rep_f).sum(dim=-1) / 2.0).to(torch.int32)
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pi = torch.where((n > 1) & (pairs_used > 0),
                     n / torch.clamp(n - 1.0, min=1.0) * quad, 0.0)
    return PiResult(pi, n, num_groups, pairs_used, pairs_total - pairs_used)


def grouped_diversity(sim: torch.Tensor, present: torch.Tensor,
                      member: torch.Tensor, threshold) -> PiResult:
    """Within-set diversity with hud.py grouped semantics: the structure of
    :func:`pi_grouped`, but each group pair takes the similarity of its
    first present element pair (hud.py:88-98), and n <= 1 gives 0."""
    f32 = torch.float32
    n_cap = member.shape[-1]
    gid = greedy_group(sim, present, member, threshold)
    sizes = group_sizes(gid, member)
    n = member.sum(dim=-1, dtype=f32)
    num_groups = (sizes > 0).sum(dim=-1, dtype=torch.int32)
    winner = first_pair_winner(present, member, gid, gid, ordered=False)
    idx = torch.clamp(gid, 0, n_cap - 1).to(torch.int64)
    freq = (torch.gather(sizes, -1, idx).to(f32)
            / torch.clamp(n, min=1.0)[..., None])
    # each winner (i, j) carries its unordered group pair's whole term
    terms = torch.where(winner, 2.0 * freq[..., :, None] * freq[..., None, :]
                        * (1.0 - sim), 0.0)
    pairs_used = winner.sum(dim=(-2, -1), dtype=torch.int32)
    pairs_total = (num_groups * (num_groups - 1)) // 2
    diversity = torch.where(
        n > 1, terms.sum(dim=(-2, -1)) * n / torch.clamp(n - 1.0, min=1.0),
        0.0)
    return PiResult(diversity, n, num_groups, pairs_used,
                    pairs_total - pairs_used)

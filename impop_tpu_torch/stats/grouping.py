"""Greedy grouping and connected components (port of
:mod:`impop_tpu.stats.grouping`).

Greedy single-link, one hop (pica2 semantics with the deterministic sorted
row order): rows are processed in ascending index; an unabsorbed row
becomes a seed and absorbs every still-unabsorbed later row whose
similarity to it exceeds the threshold (strict >).  Equivalently

    seed(i)  ⟺  no seed j < i with link(j, i)
    gid(i)   =   i if seed(i) else min{ seed j < i : link(j, i) }

Seeds and gids are bit-identical to the JAX package.
"""
from __future__ import annotations

import torch

from impop_tpu_torch.ops.seedpeel import seed_peel

__all__ = ["greedy_group", "greedy_group_panels", "group_sizes",
           "rep_weights", "first_pair_winner", "label_components"]


def greedy_group(sim: torch.Tensor, present: torch.Tensor,
                 member: torch.Tensor, threshold) -> torch.Tensor:
    """Greedy groups of the members of one matrix: gid [..., N] int32, the
    seed row of each member, N for padding rows (``greedy_group_panels``
    with the member mask as the one panel)."""
    return greedy_group_panels(sim, present, member, member[..., None, :],
                               threshold)[..., 0, :]


def greedy_group_panels(sim: torch.Tensor, present: torch.Tensor,
                        member: torch.Tensor, pmasks: torch.Tensor,
                        threshold, peel=seed_peel) -> torch.Tensor:
    """Greedy groups for P masks sharing one window's matrix.

    Args: sim/present [..., N, N], member [..., N], pmasks [..., P, N];
    ``peel`` gives (seeds, gid): the dispatching ``ops.seedpeel.seed_peel``
    by default (on CUDA tensors the seed-peel kernel writes gid in its
    walk), ``seed_gid_plain`` for a plain composition.
    Returns gid [..., P, N] int32: the seed row of each mask member, N for
    rows outside the mask.
    """
    return peel(sim, present, member, pmasks, threshold)[1]


def group_sizes(gid: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """sizes[..., s] = number of members whose group seed is row s."""
    n_cap = gid.shape[-1]
    counts = torch.zeros((*gid.shape[:-1], n_cap + 1), dtype=torch.int32,
                         device=gid.device)
    counts.scatter_add_(-1, gid.to(torch.int64), member.to(torch.int32))
    return counts[..., :n_cap]


def rep_weights(gid: torch.Tensor, member: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w [..., N] f32, n [...] f32): w[s] = |group(s)| / n at each seed row
    s, 0 elsewhere, n the member count."""
    sizes = group_sizes(gid, member)
    n = member.sum(dim=-1, dtype=torch.float32)
    w = torch.where(sizes > 0, sizes.to(torch.float32)
                    / torch.clamp(n, min=1.0)[..., None], 0.0)
    return w, n


def first_pair_winner(present: torch.Tensor, member_row: torch.Tensor,
                      gid_row: torch.Tensor, gid_col: torch.Tensor,
                      member_col: torch.Tensor | None = None,
                      ordered: bool = False) -> torch.Tensor:
    """hud.py's "first found" representative pair per group pair.

    With rows in sorted-name order the winner of a group pair is the pair
    (i, j) minimising (rank of i in its group, rank of j in its group)
    among present pairs.  Leading axes broadcast.  ``ordered=False`` keeps
    gid_row < gid_col (within-set use); ``True`` keeps gid_row != gid_col
    (cross-population).  Returns winner [..., N, N] bool.
    """
    if member_col is None:
        member_col = member_row
    n_cap = member_row.shape[-1]
    dev = present.device
    order = torch.arange(n_cap, device=dev)
    f32 = torch.float32

    valid = present & member_row[..., :, None] & member_col[..., None, :]
    if ordered:
        valid = valid & (gid_row[..., :, None] != gid_col[..., None, :])
    else:
        valid = valid & (gid_row[..., :, None] < gid_col[..., None, :])
    validf = valid.to(f32)
    # any_valid[i, g]: row i has a valid partner in column-group g
    oh_col = ((gid_col[..., :, None] == order) & member_col[..., :, None])
    any_valid = (validf @ oh_col.to(f32)) > 0.5
    earlier = order[:, None] < order[None, :]
    # blocked_row[i, g]: an earlier same-group row also reaches g
    er_f = ((gid_row[..., :, None] == gid_row[..., None, :]) & earlier
            & member_row[..., :, None] & member_row[..., None, :]).to(f32)
    blocked_row = (er_f.transpose(-1, -2) @ any_valid.to(f32)) > 0.5
    row_first = any_valid & ~blocked_row
    # col_first[i, j]: no earlier same-column-group j' valid for row i
    ec_f = ((gid_col[..., :, None] == gid_col[..., None, :]) & earlier
            & member_col[..., :, None] & member_col[..., None, :]).to(f32)
    col_first = valid & ((validf @ ec_f) < 0.5)
    idx = torch.clamp(gid_col, 0, n_cap - 1).to(torch.int64)
    idx = idx[..., None, :].expand(*row_first.shape)
    return col_first & torch.gather(row_first, -1, idx)


def label_components(adjacency: torch.Tensor, member: torch.Tensor,
                     num_iters: int | None = None) -> torch.Tensor:
    """Connected-component labels (af.py's union-find, af.py:21-33):
    reachability R = (A | I)^(2^k) from ⌈log2 N⌉ squarings of a 0/1
    float32 matrix (exact: the sums are counts below 2^24), then each
    member's label is the smallest reachable row.

    Args: adjacency [..., N, N] bool (symmetric), member [..., N] bool.
    Returns label [..., N] int32, N for padding rows.
    """
    n_cap = member.shape[-1]
    if num_iters is None:
        num_iters = max(1, (n_cap - 1).bit_length())
    eye = torch.eye(n_cap, dtype=torch.bool, device=adjacency.device)
    reach = (adjacency | eye) & member[..., :, None] & member[..., None, :]
    for _ in range(num_iters):
        rf = reach.to(torch.float32)
        reach = ((rf @ rf) > 0.5) | reach
    order = torch.arange(n_cap, dtype=torch.int32, device=adjacency.device)
    label = torch.where(reach, order, n_cap).amin(dim=-1)
    return torch.where(member, label, n_cap).to(torch.int32)

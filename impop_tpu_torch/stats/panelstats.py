"""Fused per-window panel statistics (port of
:mod:`impop_tpu.stats.panelstats`).

One window's identity matrix serves every estimator of the scan: grouped π
for each panel and each pair union, Hudson direct Fst for each pair, grouped
Hudson Fst with seed representatives, and ``seed_risk``.  Every masked
reduction is a row-dot of two stacked products against (1 - sim) and the
presence mask, after one shared grouping pass.

Pair indices are host tuples (the JAX package's traced-pair gate is not
needed here).  Leading window axes are carried through.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                            masked_pair_sums_plain)
from impop_tpu_torch.stats.fst import FstResult, _assemble
from impop_tpu_torch.stats.grouping import greedy_group_panels, group_sizes

__all__ = ["PanelStats", "panel_mask_stack", "fused_panel_stats",
           "fused_window_stats", "panel_sums", "gdxy_rows"]


class PanelStats(NamedTuple):
    pi: torch.Tensor             # [..., P+Q] raw π per panel, then pair union
    n: torch.Tensor              # [..., P+Q] member counts
    num_groups: torch.Tensor     # [..., P+Q]
    pairs_used: torch.Tensor     # [..., P+Q]
    pairs_missing: torch.Tensor  # [..., P+Q]
    hudson: FstResult            # [..., Q] direct method
    hudson_grouped: FstResult    # [..., Q] grouped method, seed reps
    seed_risk: torch.Tensor      # [...] bool: two group seeds lack data


def panel_mask_stack(pmasks, member, pair_a, pair_b, pairs_disjoint):
    """(all_masks [..., R, N], mask_a [..., Q, N], mask_b [..., Q, N]):
    panels, pair unions and, unless pairs are disjoint, both
    overlap-stripped Hudson sides.  R = P+Q (disjoint) or P+3Q."""
    ia, ib = list(pair_a), list(pair_b)
    mask_a = pmasks[..., ia, :] & member[..., None, :]
    mask_b = pmasks[..., ib, :] & member[..., None, :]
    if not pairs_disjoint:
        ov = mask_a & mask_b
        mask_a = mask_a & ~ov
        mask_b = mask_b & ~ov
    unions = pmasks[..., ia, :] | pmasks[..., ib, :]
    parts = [pmasks, unions] if pairs_disjoint else [pmasks, unions, mask_a,
                                                      mask_b]
    return torch.cat(parts, dim=-2), mask_a, mask_b


def gdxy_rows(pair_a, pair_b, pq: int, pairs_disjoint: bool):
    """Rows of the grouping stack whose weights form the grouped-Hudson
    sides: the panel rows when pairs are disjoint, the stripped-side rows
    otherwise."""
    q = len(pair_a)
    if pairs_disjoint:
        return list(pair_a), list(pair_b)
    return list(range(pq, pq + q)), list(range(pq + q, pq + 2 * q))


def panel_sums(sim, present, member, all_masks, mask_a, mask_b, threshold,
               ia, ib, pq: int, pair_sums=masked_pair_sums_plain,
               gid=None) -> dict:
    """The raw row-dots of one window's panel statistics from sim/present —
    the dict ``window_stats`` returns (without ``s``):

      quad [R], n [R], num_groups [R], pairs_used2 [PQ],
      sum/cnt aa, bb, ab [Q] (unscaled), gdxy [Q], seed_risk (0/1 f32).

    ``pair_sums`` computes the two masked reductions: the plain version by
    default (the window kernel's plain version must reach no kernel), the
    dispatching ``ops.panelquad.masked_pair_sums`` for the weighted scan.
    ``gid`` [..., R, N], when given, is the grouping of ``all_masks``
    already computed (``ops.idgroup.identity_group``); the grouping pass is
    skipped.
    """
    f32 = torch.float32
    r_count = all_masks.shape[-2]
    q = mask_a.shape[-2]
    if gid is None:
        gid = greedy_group_panels(sim, present, member, all_masks, threshold)
    pm = all_masks & member[..., None, :]
    n_all = pm.sum(dim=-1, dtype=f32)
    sizes = group_sizes(gid, pm)
    seeds = sizes > 0
    w_all = torch.where(seeds, sizes.to(f32)
                        / torch.clamp(n_all, min=1.0)[..., None], 0.0)
    a_f, b_f = mask_a.to(f32), mask_b.to(f32)
    seed_f = seeds[..., :pq, :].to(f32)
    wd = torch.cat([w_all, a_f, b_f], dim=-2)
    wp = torch.cat([seed_f, a_f, b_f], dim=-2)
    yd, yp = pair_sums(sim, present, wd, wp)

    def rowdot(x, y):
        return (x * y).sum(dim=-1)

    yd_a, yd_b = yd[..., r_count:r_count + q, :], yd[..., r_count + q:, :]
    yp_a, yp_b = yp[..., pq:pq + q, :], yp[..., pq + q:, :]
    n_cap = sim.shape[-1]
    if q > 0:
        any_seed = seeds.any(dim=-2)
        eye = torch.eye(n_cap, dtype=torch.bool, device=sim.device)
        risk = (any_seed[..., :, None] & any_seed[..., None, :] & ~present
                & ~eye).any(dim=-1).any(dim=-1)
    else:
        risk = torch.zeros(sim.shape[:-2], dtype=torch.bool,
                           device=sim.device)
    return {
        "quad": rowdot(yd[..., :r_count, :], w_all),
        "n": n_all,
        "num_groups": seeds.sum(dim=-1, dtype=f32),
        "pairs_used2": rowdot(yp[..., :pq, :], seed_f),
        "sum_aa": rowdot(yd_a, a_f), "cnt_aa": rowdot(yp_a, a_f),
        "sum_bb": rowdot(yd_b, b_f), "cnt_bb": rowdot(yp_b, b_f),
        "sum_ab": rowdot(yd_a, b_f), "cnt_ab": rowdot(yp_a, b_f),
        "gdxy": rowdot(yd[..., list(ia), :], w_all[..., list(ib), :]),
        "seed_risk": risk.to(f32),
    }


def _assemble_from_kernel(out: dict, pq: int, q: int, pair_a, pair_b,
                          pairs_disjoint: bool) -> PanelStats:
    """The epilogue on the window kernel's raw row-dots."""
    n = out["n"][..., :pq]
    quad = out["quad"][..., :pq]
    pairs_used = torch.round(out["pairs_used2"] / 2.0).to(torch.int32)
    num_groups = torch.round(out["num_groups"][..., :pq]).to(torch.int32)
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pi = torch.where((n > 1) & (pairs_used > 0),
                     n / torch.clamp(n - 1.0, min=1.0) * quad, 0.0)

    def mean(total, count):
        return torch.where(count > 0,
                           total / torch.clamp(count, min=1.0), 0.0)

    pi_a = mean(out["sum_aa"] * 0.5, out["cnt_aa"] * 0.5)
    pi_b = mean(out["sum_bb"] * 0.5, out["cnt_bb"] * 0.5)
    dxy = mean(out["sum_ab"], out["cnt_ab"])

    ia, ib = gdxy_rows(pair_a, pair_b, pq, pairs_disjoint)
    n_a, n_b = out["n"][..., ia], out["n"][..., ib]
    bessel_a = torch.where(n_a > 1, n_a / torch.clamp(n_a - 1.0, min=1.0),
                           0.0)
    bessel_b = torch.where(n_b > 1, n_b / torch.clamp(n_b - 1.0, min=1.0),
                           0.0)
    gpi_a = out["quad"][..., ia] * bessel_a
    gpi_b = out["quad"][..., ib] * bessel_b
    return PanelStats(
        pi, n, num_groups, pairs_used, pairs_total - pairs_used,
        _assemble(pi_a, pi_b, dxy),
        _assemble(gpi_a, gpi_b, out["gdxy"]),
        out["seed_risk"] > 0.5,
    )


def fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b,
                      threshold, pairs_disjoint: bool = False,
                      gid=None) -> PanelStats:
    """All panel/pair statistics of a window from its sim/present.

    Args: sim/present [..., N, N], member [..., N], pmasks [..., P, N];
    pair_a/pair_b host tuples of panel indices; pairs_disjoint a host
    promise that no haplotype is in both panels of any pair (the stripped
    sides then reuse the panel groupings); gid an optional [..., R, N]
    grouping over ``panel_mask_stack``'s masks, which skips the grouping
    pass.  On CUDA tensors the masked reductions run in the
    ``masked_pair_sums`` kernel.
    """
    all_masks, mask_a, mask_b = panel_mask_stack(
        pmasks, member, pair_a, pair_b, pairs_disjoint)
    pq = pmasks.shape[-2] + len(pair_a)
    ia, ib = gdxy_rows(pair_a, pair_b, pq, pairs_disjoint)
    out = panel_sums(sim, present, member, all_masks, mask_a, mask_b,
                     threshold, ia, ib, pq, pair_sums=masked_pair_sums,
                     gid=gid)
    return _assemble_from_kernel(out, pq, len(pair_a), pair_a, pair_b,
                                 pairs_disjoint)


def fused_window_stats(geno, member, site_mask, length, pmasks, pair_a,
                       pair_b, threshold, pairs_disjoint: bool = False,
                       return_matrices: bool = True) -> tuple:
    """Allele tiles in, every panel statistic out.

    - ``return_matrices=False`` (the scan): the whole-window kernel on CUDA
      tensors, its plain version on CPU tensors; nothing of shape [N, N]
      is returned.
    - ``return_matrices=True`` (the JAX default): ``identity_group`` (the
      fused identity + grouping kernel on CUDA tensors) writes sim,
      present, the grouping and S, then :func:`fused_panel_stats` runs on
      that grouping.

    Args: geno [..., N, S] int8 (biallelic), member [..., N], site_mask
    [..., S], length [...], pmasks [..., P, N]; pairs as host tuples.
    Returns (sim [..., N, N] f32 or None, present [..., N, N] bool or None,
    S as f32 [...], PanelStats).
    """
    if return_matrices:
        from impop_tpu_torch.ops.idgroup import identity_group

        all_masks, _, _ = panel_mask_stack(pmasks, member, pair_a, pair_b,
                                           pairs_disjoint)
        sim, present, gid, s_count = identity_group(
            geno, member, site_mask, all_masks, threshold, length)
        res = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b,
                                threshold, pairs_disjoint, gid=gid)
        return sim, present, s_count, res

    from impop_tpu_torch.ops.windowstat import window_stats

    all_masks, mask_a, mask_b = panel_mask_stack(
        pmasks, member, pair_a, pair_b, pairs_disjoint)
    pq = pmasks.shape[-2] + len(pair_a)
    out = window_stats(geno, member, site_mask, all_masks, mask_a, mask_b,
                       threshold, length, pair_a, pair_b, pairs_disjoint)
    res = _assemble_from_kernel(out, pq, len(pair_a), pair_a, pair_b,
                                pairs_disjoint)
    return None, None, out["s"], res

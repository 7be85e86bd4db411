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

import os
from typing import NamedTuple

import torch

from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                            masked_pair_sums_plain)
from impop_tpu_torch.stats.fst import FstResult, _assemble
from impop_tpu_torch.stats.grouping import greedy_group_panels, group_sizes

__all__ = ["PanelStats", "panel_mask_stack", "fused_panel_stats",
           "composed_window_stats", "fused_window_stats", "panel_sums",
           "gdxy_rows", "take"]

# Debug guard of the seed-representative grouped-Hudson invariant, read
# from the environment variable the JAX package reads: with
# IMPOP_TPU_DEBUG_INVARIANTS=1, fused_panel_stats counts the group-seed
# pairs its grouped Hudson relies on that lack data and warns when there
# are any (hud.py would then scan past the seed pair while the fused
# reduction adds nothing).  Allele-derived matrices never lack a pair; a
# sparse source might.  Off, the step gains no op and no host sync.
DEBUG_SEED_INVARIANT = os.environ.get("IMPOP_TPU_DEBUG_INVARIANTS") == "1"


def _warn_missing_seed_pairs(missing) -> None:
    import warnings

    n_bad = int(missing)
    if n_bad > 0:
        warnings.warn(
            f"fused grouped-Hudson: {n_bad} group-seed pair(s) lack data; "
            "seed-representative FSTG deviates from hud.py -m grouped here "
            "— use the exact stats/fst.hudson_fst_grouped_pairs path for "
            "this source",
            RuntimeWarning,
            stacklevel=2,
        )


def _seed_pair_guard(rep_a, rep_b, present) -> None:
    """Count the (within-A, within-B, cross) seed pairs without data over
    every window and warn when there are any (one read to the host).
    rep_a / rep_b [..., Q, N] 0/1 seed rows of the grouped-Hudson sides,
    present [..., N, N]."""
    p_f = present.to(torch.float32)

    def have(x, y):
        return torch.einsum("...qn,...nm,...qm->...q", x, p_f, y)

    g_a, g_b = rep_a.sum(dim=-1), rep_b.sum(dim=-1)
    missing = ((g_a * g_b - have(rep_a, rep_b)).sum()
               + (g_a * g_a - have(rep_a, rep_a)).sum()
               + (g_b * g_b - have(rep_b, rep_b)).sum())
    _warn_missing_seed_pairs(missing.item())


class PanelStats(NamedTuple):
    pi: torch.Tensor             # [..., P+Q] raw π per panel, then pair union
    n: torch.Tensor              # [..., P+Q] member counts
    num_groups: torch.Tensor     # [..., P+Q]
    pairs_used: torch.Tensor     # [..., P+Q]
    pairs_missing: torch.Tensor  # [..., P+Q]
    hudson: FstResult            # [..., Q] direct method
    hudson_grouped: FstResult    # [..., Q] grouped method, seed reps
    seed_risk: torch.Tensor      # [...] bool: two group seeds lack data


def take(t: torch.Tensor, idx, dim: int) -> torch.Tensor:
    """``t`` indexed along ``dim`` by the host ints ``idx``, as
    ``t[..., idx, ...]``: a slice for a run of consecutive ints, else one
    stack of selects.  A list index would be copied to a CUDA tensor's
    device, and that copy waits for the device's stream, which keeps the
    host from queuing work on the other devices of a split batch."""
    idx = [int(i) for i in idx]
    if not idx or idx == list(range(idx[0], idx[0] + len(idx))):
        return t.narrow(dim, idx[0] if idx else 0, len(idx))
    return torch.stack([t.select(dim, i) for i in idx], dim=dim)


def panel_mask_stack(pmasks, member, pair_a, pair_b, pairs_disjoint):
    """(all_masks [..., R, N], mask_a [..., Q, N], mask_b [..., Q, N]):
    panels, pair unions and, unless pairs are disjoint, both
    overlap-stripped Hudson sides.  R = P+Q (disjoint) or P+3Q."""
    pa, pb = take(pmasks, pair_a, -2), take(pmasks, pair_b, -2)
    mask_a = pa & member[..., None, :]
    mask_b = pb & member[..., None, :]
    if not pairs_disjoint:
        ov = mask_a & mask_b
        mask_a = mask_a & ~ov
        mask_b = mask_b & ~ov
    unions = pa | pb
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
        "gdxy": rowdot(take(yd, ia, -2), take(w_all, ib, -2)),
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
    n_a, n_b = take(out["n"], ia, -1), take(out["n"], ib, -1)
    bessel_a = torch.where(n_a > 1, n_a / torch.clamp(n_a - 1.0, min=1.0),
                           0.0)
    bessel_b = torch.where(n_b > 1, n_b / torch.clamp(n_b - 1.0, min=1.0),
                           0.0)
    gpi_a = take(out["quad"], ia, -1) * bessel_a
    gpi_b = take(out["quad"], ib, -1) * bessel_b
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
    ``masked_pair_sums`` kernel.  With ``DEBUG_SEED_INVARIANT`` set, the
    group-seed pairs of the grouped-Hudson sides that lack data are
    counted and warned about (one host read a call).
    """
    all_masks, mask_a, mask_b = panel_mask_stack(
        pmasks, member, pair_a, pair_b, pairs_disjoint)
    pq = pmasks.shape[-2] + len(pair_a)
    ia, ib = gdxy_rows(pair_a, pair_b, pq, pairs_disjoint)
    if gid is None:
        gid = greedy_group_panels(sim, present, member, all_masks, threshold)
    if DEBUG_SEED_INVARIANT and len(pair_a) > 0:
        seeds = group_sizes(gid, all_masks & member[..., None, :]) > 0
        _seed_pair_guard(take(seeds, ia, -2).to(torch.float32),
                         take(seeds, ib, -2).to(torch.float32), present)
    out = panel_sums(sim, present, member, all_masks, mask_a, mask_b,
                     threshold, ia, ib, pq, pair_sums=masked_pair_sums,
                     gid=gid)
    return _assemble_from_kernel(out, pq, len(pair_a), pair_a, pair_b,
                                 pairs_disjoint)


def composed_window_stats(geno, member, site_mask, length, pmasks, pair_a,
                          pair_b, threshold, pairs_disjoint: bool = False
                          ) -> tuple:
    """(S as f32 [...], PanelStats): the route of
    :func:`fused_window_stats` past the window kernel's caps, composed of
    ``identity_from_alleles`` (the unit identity kernel on CUDA tensors),
    ``segregating_sites`` and :func:`fused_panel_stats`; arguments as
    there."""
    from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                              segregating_sites)

    sim, present = identity_from_alleles(geno, member, site_mask, length)
    s_count = segregating_sites(geno, member, site_mask).to(torch.float32)
    res = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b,
                            threshold, pairs_disjoint)
    return s_count, res


def fused_window_stats(geno, member, site_mask, length, pmasks, pair_a,
                       pair_b, threshold, pairs_disjoint: bool = False,
                       return_matrices: bool = True) -> tuple:
    """Allele tiles in, every panel statistic out.

    - ``return_matrices=False`` (the scan): the whole-window kernel on CUDA
      tensors, its plain version on CPU tensors; nothing of shape [N, N]
      is returned.  Caps the kernel does not take
      (``ops.windowstat.window_kernel_fits``, e.g. more than 65 535 sites)
      take :func:`composed_window_stats` on any device, as the JAX package
      composes above its kernel's cap.
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

    from impop_tpu_torch.ops.windowstat import (window_kernel_fits,
                                                window_stats)

    if not window_kernel_fits(*geno.shape[-2:]):
        return (None, None) + composed_window_stats(
            geno, member, site_mask, length, pmasks, pair_a, pair_b,
            threshold, pairs_disjoint)

    all_masks, mask_a, mask_b = panel_mask_stack(
        pmasks, member, pair_a, pair_b, pairs_disjoint)
    pq = pmasks.shape[-2] + len(pair_a)
    out = window_stats(geno, member, site_mask, all_masks, mask_a, mask_b,
                       threshold, length, pair_a, pair_b, pairs_disjoint)
    res = _assemble_from_kernel(out, pq, len(pair_a), pair_a, pair_b,
                                pairs_disjoint)
    return None, None, out["s"], res

"""The scan's device step (twins of ``impop_tpu.cli._wire_unpacker``,
``_scan_step`` and ``_scan_step_fstg_exact``).

The step takes exactly the ``uint8 [W, K]`` buffer that
``impop_tpu.cli.pack_scan_batch`` writes and returns the same packed f32
row per window as the JAX step:

    [π per panel (P) | Tajima's D (P) | FST (Q') | FSTG (Q') | FST3 (Q') |
     S | n | seed_risk | EHH (4, with --ehh) | AFS (P·(bins+1) with --afs,
     else P zeros)]

with Q' = max(1, number of pairs) and the EHH block [area_ref, area_alt,
carriers_ref, carriers_alt].  Unit weights run the whole-window kernel;
column-mode weights run the weighted identity and masked-sum kernels.

Over several devices (the JAX scan's ``shard_map`` over every local chip,
``impop_tpu.cli._shard_windows``): :func:`shard_wire` splits the wire batch
into contiguous row chunks, one per device, padded with all-zero rows (no
members, length 0: inert); :func:`scan_step_over` queues the step of each
chunk on its device and gathers the rows back in window order on the
first device.  No window's statistics depend on another's, so the rows
equal the one-device step's.
"""
from __future__ import annotations

import numpy as np
import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.hostio import _scan_buf_layout
from impop_tpu_torch.parallel.mesh import gather_windows, split_rows
from impop_tpu_torch.stats.allele import (identity_from_alleles, panel_afs,
                                          segregating_sites)
from impop_tpu_torch.stats.ehh import ehh_area_dynamic
from impop_tpu_torch.stats.fst import hudson_fst_grouped_pairs
from impop_tpu_torch.stats.panelstats import (fused_panel_stats,
                                              fused_window_stats, take)
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["wire_unpack", "scan_step",
           "scan_step_fstg_exact", "row_layout", "shard_wire",
           "scan_step_over", "scan_step_fstg_exact_over"]


def _bits(seg: torch.Tensor, n: int) -> torch.Tensor:
    sh = torch.arange(8, dtype=torch.uint8, device=seg.device)
    b = (seg[..., None] >> sh) & 1
    return b.reshape(*seg.shape[:-1], -1)[..., :n].bool()


def wire_unpack(flat: torch.Tensor, cap_n: int, cap_s: int, p_count: int,
                use_weights: bool = False, use_ehh: bool = False):
    """[W, K] uint8 -> (geno [W, N, S] int8, member [W, N], site_mask
    [W, S], panels [W, P, N] bool, length [W] f32, site weights [W, S] f32
    or None, focal column [W] int32 or None)."""
    lay = _scan_buf_layout(cap_n, cap_s, p_count, use_weights, use_ehh)
    if flat.shape[-1] != lay["total"]:
        raise ValueError(f"wire row of {flat.shape[-1]} bytes, layout wants "
                         f"{lay['total']}")
    w = flat.shape[0]
    gp = flat[:, lay["g"]:lay["m"]].reshape(w, cap_n, cap_s // 4)
    sh = torch.arange(0, 8, 2, dtype=torch.uint8, device=flat.device)
    codes = (gp[..., None] >> sh) & 3
    geno = codes.reshape(w, cap_n, cap_s).to(torch.int8) - 1
    member = _bits(flat[:, lay["m"]:lay["sm"]], cap_n)
    smask = _bits(flat[:, lay["sm"]:lay["p"]], cap_s)
    pb = flat[:, lay["p"]:lay["l"]].reshape(w, p_count, cap_n // 8)
    panels = _bits(pb, cap_n)
    lb = flat[:, lay["l"]:lay["l"] + 4].to(torch.int64)
    length = (lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16)
              | (lb[:, 3] << 24)).to(torch.float32)
    # little-endian f32 / uint32 segments: a byte view is the bit cast
    # (the focal wraps to int32 as the JAX step's astype does)
    wts = focal = None
    if use_weights:
        wts = flat[:, lay["w"]:lay["f"]].contiguous().view(torch.float32)
    if use_ehh:
        focal = flat[:, lay["f"]:lay["f"] + 4].contiguous().view(
            torch.int32)[:, 0]
    return geno, member, smask, panels, length, wts, focal


def row_layout(p_count: int, n_pairs: int, want_ehh: bool = False) -> dict:
    """Column offsets of the packed row."""
    q = max(1, n_pairs)
    lay = {"pi": 0, "d": p_count, "fst": 2 * p_count}
    lay["fstg"] = lay["fst"] + q
    lay["f3"] = lay["fstg"] + q
    lay["s"] = lay["f3"] + q
    lay["n"] = lay["s"] + 1
    lay["risk"] = lay["n"] + 1
    lay["ehh"] = lay["risk"] + 1
    lay["afs"] = lay["ehh"] + (4 if want_ehh else 0)
    return lay


def _pairs(pair_key):
    return (tuple(a for a, _ in pair_key) or (0,),
            tuple(b for _, b in pair_key) or (0,))


def scan_step(flat: torch.Tensor, cap_n: int, cap_s: int, p_count: int,
              pair_key: tuple, threshold: float, pairs_disjoint: bool,
              use_weights: bool = False, want_ehh: bool = False,
              want_afs: bool = False, afs_bins: int = 512,
              afs_folded: bool = True) -> torch.Tensor:
    """Wire batch on a device -> packed rows [W, row width] f32 on it."""
    geno, member, smask, panels, length, wts, focal = wire_unpack(
        flat, cap_n, cap_s, p_count, use_weights, want_ehh)
    pair_a, pair_b = _pairs(pair_key)
    if use_weights:
        sim, present = identity_from_alleles(geno, member, smask, length,
                                             site_weights=wts)
        s_count = segregating_sites(geno, member, smask).to(torch.float32)
        res = fused_panel_stats(sim, present, member, panels, pair_a, pair_b,
                                threshold, pairs_disjoint)
    else:
        _, _, s_count, res = fused_window_stats(
            geno, member, smask, length, panels, pair_a, pair_b, threshold,
            pairs_disjoint, return_matrices=False)
    pi_panel = res.pi[:, :p_count]
    pi_c = res.pi[:, p_count:]
    d = tajimas_d(res.n[:, :p_count], s_count[:, None],
                  pi_panel / length[:, None])
    fst = res.hudson.fst
    fstg = res.hudson_grouped.fst if pair_key else torch.zeros_like(fst)
    pi_ab = 0.5 * (take(pi_panel, pair_a, 1) + take(pi_panel, pair_b, 1))
    nz = pi_c != 0
    f3 = torch.where(nz, (pi_c - pi_ab) / torch.where(nz, pi_c, 1.0),
                     torch.nan)
    n_all = member.sum(dim=1, dtype=torch.float32)
    cols = [pi_panel, d, fst, fstg, f3, s_count[:, None], n_all[:, None],
            res.seed_risk[:, None].float()]
    if want_ehh:
        area, carr = ehh_area_dynamic(geno, member, smask, focal)
        cols += [area, carr.to(torch.float32)]
    if want_afs:
        afs = panel_afs(geno, member, smask, panels, afs_bins, afs_folded)
        cols.append(afs.reshape(flat.shape[0], -1).to(torch.float32))
    else:
        cols.append(torch.zeros((flat.shape[0], p_count),
                                dtype=torch.float32, device=flat.device))
    return torch.cat(cols, dim=1)


def scan_step_fstg_exact(flat: torch.Tensor, cap_n: int, cap_s: int,
                         p_count: int, pair_key: tuple, threshold: float,
                         rows=None, use_weights: bool = False,
                         use_ehh: bool = False) -> torch.Tensor:
    """Exact grouped Hudson Fst (first-found representative pairs) for the
    windows ``rows`` of a wire batch (default: all) -> [len(rows), Q] f32.
    The scan re-runs windows flagged ``seed_risk`` through this; the wire
    layout flags must be the scan's, and column-mode weights give the same
    weighted identity as the step."""
    geno, member, smask, panels, length, wts, _ = wire_unpack(
        flat, cap_n, cap_s, p_count, use_weights, use_ehh)
    pair_a, pair_b = _pairs(pair_key)
    if rows is None:
        rows = range(flat.shape[0])
    out = []
    for wi in rows:
        sim, present = identity_from_alleles(
            geno[wi], member[wi], smask[wi], length[wi],
            site_weights=None if wts is None else wts[wi])
        ma = take(panels[wi], pair_a, 0) & member[wi]
        mb = take(panels[wi], pair_b, 0) & member[wi]
        ov = ma & mb
        res = hudson_fst_grouped_pairs(sim, present, ma & ~ov, mb & ~ov,
                                       threshold)
        out.append(res.fst.to(torch.float32))
    if not out:
        return torch.zeros((0, len(pair_a)), dtype=torch.float32,
                           device=flat.device)
    return torch.stack(out)


def shard_wire(flat, devices) -> list:
    """The wire batch [W, K] uint8 (numpy or a tensor) as contiguous row
    chunks, one on each of ``devices`` (which may repeat), after padding
    with all-zero rows to a multiple of their count."""
    if flat.dtype not in (np.uint8, torch.uint8) or flat.ndim != 2:
        raise ValueError(f"wire batch must be uint8 [W, K], got {flat.dtype} "
                         f"{tuple(flat.shape)}")
    return split_rows(flat, list(devices))


def scan_step_over(shards, *step_args, n_rows=None) -> torch.Tensor:
    """:func:`scan_step` (``step_args``: its arguments after the batch) on
    every chunk of :func:`shard_wire`, each queued on its own device, then
    the packed rows in window order on the first chunk's device, cut to
    ``n_rows`` (the batch before padding)."""
    outs = []
    for flat in shards:
        with on_device(flat.device):
            outs.append(scan_step(flat, *step_args))
    return gather_windows(outs, n_rows)


def scan_step_fstg_exact_over(shards, cap_n: int, cap_s: int, p_count: int,
                              pair_key: tuple, threshold: float, rows,
                              use_weights: bool = False,
                              use_ehh: bool = False) -> torch.Tensor:
    """:func:`scan_step_fstg_exact` for the windows ``rows`` (ascending
    indices into the batch before padding) of a batch split by
    :func:`shard_wire`: each chunk's rows on its device, the results in
    the order of ``rows`` on the first chunk's device."""
    rows = [int(r) for r in rows]
    if rows != sorted(rows):
        raise ValueError("scan_step_fstg_exact_over: rows must ascend")
    size = shards[0].shape[0]
    outs = []
    for k, flat in enumerate(shards):
        local = [r - k * size for r in rows if k * size <= r < (k + 1) * size]
        if local or (k == 0 and not rows):
            with on_device(flat.device):
                outs.append(scan_step_fstg_exact(
                    flat, cap_n, cap_s, p_count, pair_key, threshold,
                    rows=local, use_weights=use_weights, use_ehh=use_ehh))
    return gather_windows(outs)

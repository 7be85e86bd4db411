"""The scan's device step (twins of ``impop_tpu.cli._wire_unpacker``,
``_scan_step`` and ``_scan_step_fstg_exact``), unit weights, no EHH, no AFS.

The step takes exactly the ``uint8 [W, K]`` buffer that
``impop_tpu.cli.pack_scan_batch`` writes and returns the same packed f32
row per window as the JAX step:

    [π per panel (P) | Tajima's D (P) | FST (Q') | FSTG (Q') | FST3 (Q') |
     S | n | seed_risk | AFS placeholder zeros (P)]

with Q' = max(1, number of pairs).
"""
from __future__ import annotations

import numpy as np
import torch

from impop_tpu_torch.hostio import _scan_buf_layout
from impop_tpu_torch.stats.allele import identity_from_alleles
from impop_tpu_torch.stats.fst import hudson_fst_grouped_pairs
from impop_tpu_torch.stats.panelstats import fused_window_stats
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["batch_to_device", "wire_unpack", "scan_step",
           "scan_step_fstg_exact", "row_layout"]


def batch_to_device(flat: np.ndarray, device) -> torch.Tensor:
    """The packed wire batch [W, K] uint8 onto ``device``."""
    if flat.dtype != np.uint8 or flat.ndim != 2:
        raise ValueError(f"wire batch must be uint8 [W, K], got {flat.dtype} "
                         f"{flat.shape}")
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device)


def _bits(seg: torch.Tensor, n: int) -> torch.Tensor:
    sh = torch.arange(8, dtype=torch.uint8, device=seg.device)
    b = (seg[..., None] >> sh) & 1
    return b.reshape(*seg.shape[:-1], -1)[..., :n].bool()


def wire_unpack(flat: torch.Tensor, cap_n: int, cap_s: int, p_count: int):
    """[W, K] uint8 -> (geno [W, N, S] int8, member [W, N], site_mask
    [W, S], panels [W, P, N] bool, length [W] f32)."""
    lay = _scan_buf_layout(cap_n, cap_s, p_count, False)
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
    return geno, member, smask, panels, length


def row_layout(p_count: int, n_pairs: int) -> dict:
    """Column offsets of the packed row."""
    q = max(1, n_pairs)
    lay = {"pi": 0, "d": p_count, "fst": 2 * p_count}
    lay["fstg"] = lay["fst"] + q
    lay["f3"] = lay["fstg"] + q
    lay["s"] = lay["f3"] + q
    lay["n"] = lay["s"] + 1
    lay["risk"] = lay["n"] + 1
    lay["afs"] = lay["risk"] + 1
    return lay


def _pairs(pair_key):
    return (tuple(a for a, _ in pair_key) or (0,),
            tuple(b for _, b in pair_key) or (0,))


def scan_step(flat: torch.Tensor, cap_n: int, cap_s: int, p_count: int,
              pair_key: tuple, threshold: float,
              pairs_disjoint: bool) -> torch.Tensor:
    """Wire batch on a device -> packed rows [W, 3P + 3Q' + 3] f32 on it."""
    geno, member, smask, panels, length = wire_unpack(flat, cap_n, cap_s,
                                                      p_count)
    pair_a, pair_b = _pairs(pair_key)
    s_count, res = fused_window_stats(geno, member, smask, length, panels,
                                      pair_a, pair_b, threshold,
                                      pairs_disjoint)
    pi_panel = res.pi[:, :p_count]
    pi_c = res.pi[:, p_count:]
    d = tajimas_d(res.n[:, :p_count], s_count[:, None],
                  pi_panel / length[:, None])
    fst = res.hudson.fst
    fstg = res.hudson_grouped.fst if pair_key else torch.zeros_like(fst)
    pi_ab = 0.5 * (pi_panel[:, list(pair_a)] + pi_panel[:, list(pair_b)])
    nz = pi_c != 0
    f3 = torch.where(nz, (pi_c - pi_ab) / torch.where(nz, pi_c, 1.0),
                     torch.nan)
    n_all = member.sum(dim=1, dtype=torch.float32)
    afs = torch.zeros((flat.shape[0], p_count), dtype=torch.float32,
                      device=flat.device)
    return torch.cat([pi_panel, d, fst, fstg, f3, s_count[:, None],
                      n_all[:, None], res.seed_risk[:, None].float(), afs],
                     dim=1)


def scan_step_fstg_exact(flat: torch.Tensor, cap_n: int, cap_s: int,
                         p_count: int, pair_key: tuple, threshold: float,
                         rows=None) -> torch.Tensor:
    """Exact grouped Hudson Fst (first-found representative pairs) for the
    windows ``rows`` of a wire batch (default: all) -> [len(rows), Q] f32.
    The scan re-runs windows flagged ``seed_risk`` through this."""
    geno, member, smask, panels, length = wire_unpack(flat, cap_n, cap_s,
                                                       p_count)
    pair_a, pair_b = _pairs(pair_key)
    if rows is None:
        rows = range(flat.shape[0])
    out = []
    for wi in rows:
        sim, present = identity_from_alleles(geno[wi], member[wi],
                                             smask[wi], length[wi])
        ma = panels[wi, list(pair_a)] & member[wi]
        mb = panels[wi, list(pair_b)] & member[wi]
        ov = ma & mb
        res = hudson_fst_grouped_pairs(sim, present, ma & ~ov, mb & ~ov,
                                       threshold)
        out.append(res.fst.to(torch.float32))
    if not out:
        return torch.zeros((0, len(pair_a)), dtype=torch.float32,
                           device=flat.device)
    return torch.stack(out)

"""The plain reference in PyTorch: every cell of one scan row of the
HPRC v2 selection scan, from one window's allele matrix, site weights and
panel masks, on any device (a CPU or the card), with no kernels and no
batching.  It imports torch and NumPy only.

The row: π and Tajima's D per panel; Hudson direct, grouped and 3-π Fst
per pair; S; the EHH focal, areas and carriers; the folded spectrum of
each panel.  The estimators are the reference scripts' as
``benchmark/reference.py`` states them (pica2 grouped π, hud.py's direct
and grouped Fst, the 3-π Fst, tj_d.py's D, ehhgfa.py's decay areas,
op-afs.py's folded spectrum), and the semantics are the program's:

- identity ``sim = 1 - diff / length`` in float32, ``diff`` the pair's
  differing sites, each weighed by its alignment columns in columns mode
  (an exact integer, summed in float64); linked when ``sim > threshold``
  in float32;
- every sum and quotient after that in float64, with TF32 off
  (``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` are set False before any product).

Departures from the reference scripts, all the program's own:

- identity comes from the window's allele matrix, not from impg's
  similarity table, and the threshold test is in float32, not in Python
  floats (``benchmark/reference.py``, ``test_threshold_test_is_float32``);
- groups are greedy one-hop groups seeded in sorted-name order (hud.py
  walks its table's order);
- Tajima's D takes S over every row of the window and π per site of the
  panel (the scan's TAJD column);
- EHH: the focal is the site nearest the window's midpoint; an area is
  the steps over which the pairs of one allele's carriers stay identical,
  walking away from the focal left and right, over C(carriers, 2), with
  no cut-off (ehhgfa.py stops at an EHH threshold);
- the spectrum counts a panel's minor allele over biallelic sites with no
  missing call, folded, counts above ``bins`` in the last bin.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["window_row", "tajimas_d"]

F64 = torch.float64


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tajimas_d(n: int, s: float, pi: float) -> float:
    """tj_d.py: D = (π − S/a1) / sqrt(e1·S + e2·S(S−1)); NaN when S is 0
    or n < 2."""
    if n < 2 or s <= 0:
        return float("nan")
    i = torch.arange(1, n, dtype=F64)
    a1 = float((1.0 / i).sum())
    a2 = float((1.0 / (i * i)).sum())
    b1 = (n + 1.0) / (3.0 * (n - 1.0))
    b2 = 2.0 * (n * n + n + 3.0) / (9.0 * n * (n - 1.0))
    c1 = b1 - 1.0 / a1
    c2 = b2 - (n + 2.0) / (a1 * n) + a2 / (a1 * a1)
    e1, e2 = c1 / a1, c2 / (a1 * a1 + a2)
    den = math.sqrt(max(e1 * s + e2 * s * (s - 1.0), 0.0))
    return (pi - s / a1) / den if den > 0 else float("nan")


def _identity(x: torch.Tensor, w: torch.Tensor, length: int
              ) -> torch.Tensor:
    """sim [N, N] float32 with a unit diagonal: 1 - diff / length."""
    xc = 1.0 - x
    diff = (x * w) @ xc.T + (xc * w) @ x.T            # exact integers
    sim = torch.tensor(1.0, dtype=torch.float32, device=x.device) - (
        diff.to(torch.float32)
        / torch.tensor(float(max(length, 1)), dtype=torch.float32,
                       device=x.device))
    sim.fill_diagonal_(1.0)
    return sim


def _greedy(link: torch.Tensor, members: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seed rows, group sizes): a seed, the first member not yet taken,
    absorbs every later untaken member it links to."""
    rem = members
    seeds, sizes = [], []
    while rem.numel():
        s = rem[0]
        hit = link[s, rem[1:]]
        seeds.append(s)
        sizes.append(1 + int(hit.sum()))
        rem = rem[1:][~hit]
    return (torch.stack(seeds) if seeds else members[:0],
            torch.tensor(sizes, dtype=F64, device=members.device))


def _pair_steps(x: torch.Tensor) -> int:
    """Σ over row pairs i < j of the leading columns on which rows i and j
    agree."""
    if x.shape[0] < 2 or x.shape[1] == 0:
        return 0
    eq = (x[:, None, :] == x[None, :, :]).to(torch.int64)
    steps = torch.cumprod(eq, dim=2).sum(dim=2)
    return int(torch.triu(steps, 1).sum())


def _ehh(x: torch.Tensor, focal: int) -> Tuple[float, float, int, int]:
    """(area of allele 0, area of allele 1, carriers of 0, carriers of 1)
    at column ``focal`` of the 0/1 matrix ``x``."""
    areas, carriers = [], []
    for allele in (0, 1):
        rows = x[x[:, focal] == allele]
        steps = (_pair_steps(rows[:, focal + 1:])
                 + _pair_steps(torch.flip(rows[:, :focal], dims=(1,))))
        c = rows.shape[0]
        areas.append(steps / max(c * (c - 1) / 2.0, 1.0))
        carriers.append(c)
    return areas[0], areas[1], carriers[0], carriers[1]


def _afs(x: torch.Tensor, masks: torch.Tensor, bins: int) -> torch.Tensor:
    """[P, bins + 1] int64: sites whose minor allele count among a panel's
    rows is k."""
    ones = masks.to(F64) @ x                                  # [P, S]
    total = masks.sum(dim=1, dtype=F64)[:, None]
    poly = (ones > 0) & (ones < total)
    count = torch.clamp(torch.minimum(ones, total - ones), 0, bins).long()
    hist = torch.zeros((masks.shape[0], bins + 1), dtype=torch.int64,
                       device=x.device)
    for p in range(masks.shape[0]):
        hist[p].index_add_(0, count[p][poly[p]],
                           torch.ones_like(count[p][poly[p]]))
    return hist


def window_row(geno, masks, length: int, pairs: Sequence[Tuple[int, int]],
               threshold: float, weights=None, pos=None,
               mid: Optional[int] = None, afs_bins: Optional[int] = None,
               device="cpu") -> Dict:
    """One window's row.

    geno [N, S] 0/1 over every row of the window (rows in sorted-name
    order, no missing call), masks [P, N] bool, ``pairs`` disjoint panel
    index pairs, ``weights`` [S] each site's alignment columns (columns
    mode) or None (1 each), ``pos`` [S] the sites' positions and ``mid``
    the window's midpoint (the EHH focal is the site nearest it, the first
    of a tie; ``pos`` None: no EHH), ``afs_bins`` the
    spectrum's largest count (None: no spectrum).  Arrays may be NumPy or
    torch; the work runs on ``device``.

    Returns NumPy values: ``n``, ``s``, ``pi`` [P] (per site times the
    window: the PI column times ``length``), ``tajd`` [P], ``fst`` /
    ``fstg`` / ``fst3`` [Q], ``groups`` [P] and ``union_groups`` [Q]; with
    ``pos``, ``focal`` (column), ``focal_pos``, ``carriers`` (of 0, of 1)
    and ``ehh`` (area 0, area 1, carriers 0, carriers 1); with
    ``afs_bins``, ``afs`` [P, afs_bins + 1]."""
    _no_tf32()
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(geno), device=dev).to(F64)
    m = torch.as_tensor(np.asarray(masks), device=dev).bool()
    if x.shape[1] == 0:
        raise ValueError("window without sites")
    w = (torch.ones(x.shape[1], dtype=F64, device=dev) if weights is None
         else torch.as_tensor(np.asarray(weights), device=dev).to(F64))
    sim = _identity(x, w, length).to(F64)
    link = sim > float(np.float32(threshold))
    dis = 1.0 - sim
    s_count = int((x.amax(dim=0) > x.amin(dim=0)).sum())

    def grouped(mask):
        members = torch.nonzero(mask).flatten()
        seeds, sizes = _greedy(link, members)
        n = float(members.numel())
        wts = sizes / max(n, 1.0)
        quad = float(wts @ dis[seeds][:, seeds] @ wts)
        pi = n / (n - 1.0) * quad if n > 1 and seeds.numel() > 1 else 0.0
        return pi, seeds, wts, n

    def mean_pairs(ma, mb=None):
        ia = torch.nonzero(ma).flatten()
        if mb is None:
            cnt = ia.numel() * (ia.numel() - 1) / 2.0
            tot = float(torch.triu(dis[ia][:, ia], 1).sum())
        else:
            sub = dis[ia][:, torch.nonzero(mb).flatten()]
            cnt, tot = float(sub.numel()), float(sub.sum())
        return tot / cnt if cnt > 0 else 0.0

    def fst(pi_a, pi_b, dxy):
        return (dxy - 0.5 * (pi_a + pi_b)) / dxy if dxy > 0 else 0.0

    panel = [grouped(m[i]) for i in range(m.shape[0])]
    pi = [g[0] for g in panel]
    out = {"n": x.shape[0], "s": s_count, "pi": np.asarray(pi),
           "tajd": np.asarray([tajimas_d(int(g[3]), float(s_count),
                                         g[0] / length) for g in panel]),
           "groups": np.asarray([g[1].numel() for g in panel], np.int64)}
    fst_d, fst_g, fst_3, union = [], [], [], []
    for a, b in pairs:
        fst_d.append(fst(mean_pairs(m[a]), mean_pairs(m[b]),
                         mean_pairs(m[a], m[b])))
        _, sa, wa, _ = panel[a]
        _, sb, wb, _ = panel[b]
        fst_g.append(fst(pi[a], pi[b], float(wa @ dis[sa][:, sb] @ wb)))
        pi_c, seeds_c, _, _ = grouped(m[a] | m[b])
        union.append(seeds_c.numel())
        pi_ab = 0.5 * (pi[a] + pi[b])
        fst_3.append((pi_c - pi_ab) / pi_c if pi_c != 0 else float("nan"))
    out.update(fst=np.asarray(fst_d), fstg=np.asarray(fst_g),
               fst3=np.asarray(fst_3),
               union_groups=np.asarray(union, np.int64))
    if pos is not None:
        pos_t = torch.as_tensor(np.asarray(pos), device=dev).to(torch.int64)
        fi = int(torch.argmin(torch.abs(pos_t - int(mid))))
        e = _ehh(x, fi)
        out.update(focal=fi, focal_pos=int(pos_t[fi]), carriers=e[2:],
                   ehh=e)
    if afs_bins is not None:
        out["afs"] = _afs(x, m, int(afs_bins)).cpu().numpy()
    return out

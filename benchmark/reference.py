"""The plain reference: every statistic of one scan row in NumPy.

It follows the reference scripts' estimators as the repository states them
(pica2 grouped π, Hudson direct and grouped Fst, 3-π Fst, Tajima's D of
tj_d.py, ehhgfa's EHH decay areas and the folded allele-frequency
spectrum) on one window's allele matrix, which the caller works out from
the generator's record.  It imports nothing of the program.

Identity is the program's stated semantics: ``sim = 1 - diff / length`` in
float32 (``diff`` the pairs' differing sites, each weighed by its
alignment columns in columns mode), linked when ``sim > threshold`` in
float32; rows in sorted-name order seed the greedy groups.  Every sum and
quotient after that is float64.  ``mantissa`` rounds every float value to
that many explicit mantissa bits (10: TF32) wherever the float32 program
would hold one: the control of the comparison.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["round_mantissa", "window_stats", "tajimas_d",
           "panel_afs", "ehh_areas"]


def round_mantissa(x, bits: Optional[int]):
    """``x`` rounded to ``bits`` explicit mantissa bits, to nearest even
    (float64 in, float64 out); ``bits=None`` leaves it."""
    if bits is None:
        return x
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)
    scale = float(1 << (bits + 1))
    return np.ldexp(np.round(m * scale) / scale, e)


def tajimas_d(n: int, s: float, pi: float,
              mantissa: Optional[int] = None) -> float:
    """tj_d.py: D = (π − S/a1) / sqrt(e1·S + e2·S(S−1)); NaN when S is 0
    or n < 2.  ``mantissa`` rounds each constant and step."""
    if n < 2 or s <= 0:
        return float("nan")
    rd = lambda v: float(round_mantissa(v, mantissa))  # noqa: E731
    a1 = rd(sum(1.0 / i for i in range(1, n)))
    a2 = rd(sum(1.0 / (i * i) for i in range(1, n)))
    b1 = rd((n + 1.0) / (3.0 * (n - 1.0)))
    b2 = rd(2.0 * (n * n + n + 3.0) / (9.0 * n * (n - 1.0)))
    c1 = rd(b1 - 1.0 / a1)
    c2 = rd(b2 - (n + 2.0) / (a1 * n) + a2 / (a1 * a1))
    e1, e2 = rd(c1 / a1), rd(c2 / (a1 * a1 + a2))
    den = rd(math.sqrt(max(e1 * s + e2 * s * (s - 1.0), 0.0)))
    return rd((pi - s / a1) / den) if den > 0 else float("nan")


def _greedy(link: np.ndarray, members: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(seed rows, group sizes): greedy one-hop groups of ``members``
    (ascending rows); a seed absorbs every later unabsorbed member it is
    linked to."""
    rem = members
    seeds: List[int] = []
    sizes: List[int] = []
    while rem.size:
        s = int(rem[0])
        hit = link[s, rem[1:]]
        seeds.append(s)
        sizes.append(1 + int(hit.sum()))
        rem = rem[1:][~hit]
    return np.asarray(seeds, np.int64), np.asarray(sizes, np.float64)


def window_stats(geno: np.ndarray, masks: np.ndarray, length: int,
                 pairs: Sequence[Tuple[int, int]], threshold: float,
                 weights: Optional[np.ndarray] = None,
                 mantissa: Optional[int] = None) -> dict:
    """One window's panel statistics: ``n``, ``s``, ``pi`` [P] (π per
    site, before the PI column's division by length), ``tajd`` [P],
    ``fst`` / ``fstg`` / ``fst3`` [Q], and the number of groups of each
    panel (``groups`` [P]) and of each pair's union (``union_groups``
    [Q]).

    geno [N, S] 0/1 int8 over every row (no missing calls), masks [P, N]
    bool, ``pairs`` panel index pairs (disjoint panels), ``weights`` [S]
    per-site alignment columns (columns mode) or None (events: 1 each)."""
    rd = lambda v: round_mantissa(v, mantissa)  # noqa: E731
    x = geno.astype(np.float64)
    w = np.ones(x.shape[1]) if weights is None else weights.astype(np.float64)
    xc = 1.0 - x
    diff = (x * w) @ xc.T + (xc * w) @ x.T            # exact integers
    n_all = x.shape[0]
    s_count = int(((x.max(axis=0) > x.min(axis=0))).sum()) if x.size else 0
    if x.shape[1] == 0:
        raise ValueError("window without sites")
    sim32 = np.float32(1.0) - (diff.astype(np.float32)
                               / np.float32(max(length, 1)))
    sim = rd(sim32.astype(np.float64))
    np.fill_diagonal(sim, 1.0)
    link = sim > rd(float(np.float32(threshold)))
    dis = rd(1.0 - sim)                               # (1 - sim), [N, N]

    def grouped(mask):
        members = np.nonzero(mask)[0]
        seeds, sizes = _greedy(link, members)
        n = float(members.size)
        wts = rd(sizes / max(n, 1.0))
        quad = float(rd(wts @ dis[np.ix_(seeds, seeds)] @ wts))
        pi = n / (n - 1.0) * quad if n > 1 and seeds.size > 1 else 0.0
        return pi, seeds, wts, n

    def mean_pairs(ma, mb=None):
        if mb is None:
            idx = np.nonzero(ma)[0]
            sub = dis[np.ix_(idx, idx)]
            cnt = idx.size * (idx.size - 1) / 2.0
            tot = float(np.triu(sub, 1).sum())
        else:
            sub = dis[np.ix_(np.nonzero(ma)[0], np.nonzero(mb)[0])]
            cnt, tot = float(sub.size), float(sub.sum())
        return rd(tot / cnt) if cnt > 0 else 0.0

    def fst(pi_a, pi_b, dxy):
        pxy = rd(0.5 * (pi_a + pi_b))
        return float(rd((dxy - pxy) / dxy)) if dxy > 0 else 0.0

    p = masks.shape[0]
    panel = [grouped(masks[i]) for i in range(p)]
    pi = np.asarray([g[0] for g in panel])
    out = {"n": n_all, "s": s_count, "pi": rd(pi)}
    out["tajd"] = np.asarray([
        tajimas_d(int(panel[i][3]), float(s_count), float(rd(pi[i] / length)),
                  mantissa)
        for i in range(p)])
    fst_d, fst_g, fst_3, union_groups = [], [], [], []
    for a, b in pairs:
        ma, mb = masks[a], masks[b]
        fst_d.append(fst(mean_pairs(ma), mean_pairs(mb), mean_pairs(ma, mb)))
        _, sa, wa, _ = panel[a]
        _, sb, wb, _ = panel[b]
        gdxy = float(rd(wa @ dis[np.ix_(sa, sb)] @ wb))
        fst_g.append(fst(pi[a], pi[b], gdxy))
        pi_c, seeds_c, _, _ = grouped(ma | mb)
        union_groups.append(seeds_c.size)
        pi_ab = 0.5 * (pi[a] + pi[b])
        fst_3.append(float(rd((pi_c - pi_ab) / pi_c)) if pi_c != 0
                     else float("nan"))
    out["fst"], out["fstg"], out["fst3"] = (np.asarray(fst_d),
                                            np.asarray(fst_g),
                                            np.asarray(fst_3))
    out["groups"] = np.asarray([g[1].size for g in panel], np.int64)
    out["union_groups"] = np.asarray(union_groups, np.int64)
    return out


def _pair_steps(x: np.ndarray) -> int:
    """Σ over row pairs i < j of the number of leading columns on which
    rows i and j agree."""
    if x.shape[0] < 2 or x.shape[1] == 0:
        return 0
    eq = x[:, None, :] == x[None, :, :]
    steps = np.cumprod(eq, axis=2, dtype=np.int64).sum(axis=2)
    return int(np.triu(steps, 1).sum())


def ehh_areas(geno: np.ndarray, focal: int, mantissa: Optional[int] = None
              ) -> Tuple[float, float, int, int]:
    """(area of allele 0, area of allele 1, carriers of 0, carriers of 1)
    at column ``focal``: for the carriers of an allele, the steps each
    pair stays identical walking away from the focal, left and right,
    over C(carriers, 2)."""
    x = (geno == 1)
    out_a, out_c = [], []
    for allele in (0, 1):
        rows = x[x[:, focal] == bool(allele)]
        steps = (_pair_steps(rows[:, focal + 1:])
                 + _pair_steps(rows[:, :focal][:, ::-1]))
        c = rows.shape[0]
        denom = max(c * (c - 1) / 2.0, 1.0)
        out_a.append(float(round_mantissa(steps / denom, mantissa)))
        out_c.append(c)
    return out_a[0], out_a[1], out_c[0], out_c[1]


def panel_afs(geno: np.ndarray, masks: np.ndarray, bins: int) -> np.ndarray:
    """[P, bins + 1] folded spectrum of one window per panel: sites whose
    minor allele count among the panel's rows is k."""
    ones = masks.astype(np.int64) @ (geno == 1).astype(np.int64)   # [P, S]
    total = masks.sum(axis=1, dtype=np.int64)[:, None]
    poly = (ones > 0) & (ones < total)
    count = np.clip(np.minimum(ones, total - ones), 0, bins)
    hist = np.zeros((masks.shape[0], bins + 1), np.int64)
    for p in range(masks.shape[0]):
        np.add.at(hist[p], count[p][poly[p]], 1)
    return hist

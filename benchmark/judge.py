"""What every command's comparison shares: the reference's view of the
windows (:class:`WindowTruth`), the tally of wrong cells and widest gaps
(:class:`Tally`), the walk over the calls' tables (:func:`judge_tables`)
and the seeded sample of windows whose float cells are compared
(:func:`pick_sample`).  What a command's table holds, and so which cells
are compared, is the command's own: ``benchmark/commands/<command>.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark import datagen as dg
from benchmark import reference as ref

__all__ = ["Call", "WindowTruth", "Tally", "judge_tables", "pick_sample"]

Window = Tuple[int, int]


@dataclasses.dataclass
class Call:
    windows: List[Window]
    table: str                 # the emitted TSV
    afs: Optional[str]         # the emitted spectrum file, with --afs
    error: Optional[str] = None


class WindowTruth:
    """The reference's view of the windows of one pangenome, computed once
    a window."""

    def __init__(self, pg: dg.Pangenome, cfg: dict,
                 mantissa: Optional[int] = None) -> None:
        self.pg, self.cfg, self.mantissa = pg, cfg, mantissa
        sc = cfg["scan"]
        self.labels = sorted(pg.panels)
        self.pairs = [(i, j) for i in range(len(self.labels))
                      for j in range(i + 1, len(self.labels))]
        self.columns = sc["identity_mode"] == "columns"
        self.ehh = bool(sc.get("ehh"))
        self.bins = int(sc.get("afs_bins", 512))
        self._facts: Dict[Window, dict] = {}
        self._stats: Dict[Window, dict] = {}

    def region(self, w: Window) -> str:
        return f"{self.cfg['scan']['prefix']}{self.pg.chrom}:{w[0]}-{w[1]}"

    def facts(self, w: Window) -> dict:
        """Allele matrix, masks and the exact cells of window ``w``."""
        f = self._facts.get(w)
        if f is None:
            idx, col, keys = dg.window_sites(self.pg, *w)
            _, rows = dg.row_names(self.pg, *w)
            geno = dg.window_geno(self.pg, rows, idx)
            masks = dg.panel_masks(self.pg, rows)
            s = int((geno.max(axis=0) > geno.min(axis=0)).sum())
            f = {"geno": geno, "masks": masks, "n": geno.shape[0], "s": s,
                 "keys": keys, "pos": col}
            if self.ehh:
                mid = (w[0] + w[1]) // 2
                fi = int(np.argmin(np.abs(col - mid)))
                x = geno[:, fi] == 1
                f.update(focal=fi, focal_pos=int(col[fi]),
                         carriers=(int((~x).sum()), int(x.sum())))
            self._facts[w] = f
        return f

    def weights(self, keys: Sequence[str]) -> Optional[np.ndarray]:
        if not self.columns:
            return None
        out = np.ones(len(keys))
        for i, k in enumerate(keys):
            r, a = k.split(":", 1)[1].split(">", 1)
            out[i] = max(len(r), len(a), 1)
        return out

    def stats(self, w: Window) -> dict:
        st = self._stats.get(w)
        if st is None:
            f = self.facts(w)
            st = ref.window_stats(f["geno"], f["masks"], w[1] - w[0],
                                  self.pairs, self.cfg["scan"]["threshold"],
                                  self.weights(f["keys"]), self.mantissa)
            if self.ehh:
                st["ehh"] = ref.ehh_areas(f["geno"], f["focal"],
                                          self.mantissa)
            self._stats[w] = st
        return st

    def afs(self, w: Window) -> np.ndarray:
        f = self.facts(w)
        if "afs" not in f:
            f["afs"] = ref.panel_afs(f["geno"], f["masks"], self.bins)
        return f["afs"]


def _num(cell: str) -> float:
    return float("nan") if cell == "NA" else float(cell)


class Tally:
    def __init__(self) -> None:
        self.wrong = 0
        self.gap: Dict[str, float] = {}     # widest gap by number
        self.notes: List[str] = []

    def bad(self, what: str) -> None:
        self.wrong += 1
        if len(self.notes) < 5:
            self.notes.append(what)

    def float_cell(self, key: str, got: str, want: float, where: str,
                   relative: bool = False) -> None:
        g = _num(got)
        if math.isnan(want) or math.isnan(g):
            if math.isnan(want) != math.isnan(g):
                self.bad(f"{where}: {got} against {want!r}")
            return
        d = abs(g - want)
        if relative:
            d /= max(abs(want), 1e-30)
        self.gap[key] = max(self.gap.get(key, 0.0), d)


def judge_tables(truth: WindowTruth, calls: Sequence[Call],
                 check_row: Callable[[Tally, Window, List[str],
                                      Dict[str, int]], None]) -> Tally:
    """Every call's table held to the window list it was asked for (one
    row a window, in order), each row handed to ``check_row`` with the
    table's column index; a failed call counts each of its windows
    wrong."""
    t = Tally()
    for call in calls:
        if call.error is not None:
            t.bad(f"call failed: {call.error}")
            t.wrong += len(call.windows) - 1
            continue
        with open(call.table) as fh:
            lines = fh.read().splitlines()
        col = {name: i for i, name in enumerate(lines[0].split("\t"))}
        rows = lines[1:]
        if len(rows) != len(call.windows):
            t.bad(f"{len(rows)} rows for {len(call.windows)} windows")
            t.wrong += abs(len(rows) - len(call.windows))
        for w, line in zip(call.windows, rows):
            cells = line.split("\t")
            where = truth.region(w)
            if cells[col["REGION"]] != where:
                t.bad(f"row {cells[col['REGION']]} where {where} was due")
                continue
            check_row(t, w, cells, col)
    return t


def pick_sample(truth: WindowTruth, calls: Sequence[Call], k: int,
                seed: int, queries: bool) -> List[Window]:
    """A seeded sample of the windows the calls asked for, with the
    densest window of the run in it.  For queries, whole calls: the
    longest locus first, then others until ``k`` windows."""
    rng = dg.rng_for(seed, 2)
    done = [c for c in calls if c.error is None]
    if not done:
        return []
    if queries:
        longest = max(done, key=lambda c: len(c.windows))
        picked = [longest] + [done[i] for i in rng.permutation(len(done))
                              if done[i] is not longest]
        out: List[Window] = []
        for c in picked:
            if len(out) >= k:
                break
            out += [w for w in c.windows if w not in out]
        return out
    distinct = sorted({w for c in done for w in c.windows})
    densest = max(distinct, key=lambda w: truth.facts(w)["s"])
    rest = [distinct[i] for i in rng.permutation(len(distinct))
            if distinct[i] != densest]
    return [densest] + rest[:k - 1]

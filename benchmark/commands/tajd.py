"""``tajd --geno-dir``: segregating sites, grouped π and Tajima's D of
each window over all its rows, from allele tiles.

Every row is held to the window list and its SAMPLES and
SEGREGATING_SITES to the plain reference; PI and TAJIMAS_D of the sampled
windows to the reference over every row.  Numbers: ``rows_wrong``,
``stat_gap`` (PI, absolute), ``tajd_gap`` (absolute)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark import reference as ref
from benchmark.judge import Call, WindowTruth, judge_tables

Window = Tuple[int, int]


def argv(cfg: dict, mix: dict, inputs: dict, paths: Dict[str, str],
         device: str) -> List[str]:
    sc = cfg["scan"]
    return ["tajd", "-b", paths["bed"], "-P", sc["prefix"], "-t",
            str(sc["threshold"]), "--geno-dir", inputs["tiles"], "-o",
            paths["table"], "--device", device]


def judge(truth: WindowTruth, calls: Sequence[Call], sample: Sequence[Window],
          check_all_rows: bool = True) -> Tuple[Dict[str, float], List[str]]:
    full = set(sample)
    threshold = truth.cfg["scan"]["threshold"]

    def check(t, w, cells, col):
        where, f = truth.region(w), truth.facts(w)
        length = w[1] - w[0]
        for name, want in (("LENGTH", length), ("SAMPLES", f["n"]),
                           ("SEGREGATING_SITES", f["s"])):
            if cells[col[name]] != str(want):
                t.bad(f"{where} {name} {cells[col[name]]} against {want}")
        if w not in full:
            return
        st = ref.window_stats(f["geno"], np.ones((1, f["n"]), bool), length,
                              [], threshold, truth.weights(f["keys"]),
                              truth.mantissa)
        t.float_cell("stat_gap", cells[col["PI"]], st["pi"][0] / length,
                     where)
        t.float_cell("tajd_gap", cells[col["TAJIMAS_D"]], st["tajd"][0],
                     where)

    t = judge_tables(truth, calls, check)
    return ({"rows_wrong": float(t.wrong),
             "stat_gap": t.gap.get("stat_gap", 0.0),
             "tajd_gap": t.gap.get("tajd_gap", 0.0)}, t.notes)

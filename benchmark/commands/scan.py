"""``scan``: one fused call per window list (π and Tajima's D per panel,
Hudson direct, grouped and 3-π Fst per pair, EHH and the spectrum when
configured).

Every row of every call is held to the window list it was asked for and
its integer cells (SAMPLES, SEGREGATING_SITES, EHH focal and carriers) to
the plain reference; with ``--afs`` every call's spectrum file is compared
whole.  The float cells (PI, TAJD, FST, FSTG, FST3, EHH areas) of the
sampled windows are compared in every row that holds them.  Numbers:

- ``rows_wrong``: rows or cells that differ where the answer is exact;
- ``stat_gap``: the widest absolute gap of a PI, FST, FSTG or FST3 cell;
- ``tajd_gap``: the widest absolute gap of a TAJD cell;
- ``ehh_gap``: the widest relative gap of an EHH area (with ``--ehh``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.judge import Call, Tally, WindowTruth, judge_tables

Window = Tuple[int, int]


def argv(cfg: dict, mix: dict, inputs: dict, paths: Dict[str, str],
         device: str) -> List[str]:
    """``impop_tpu_torch.cli`` arguments of one call."""
    sc = cfg["scan"]
    out = ["scan", "-b", paths["bed"], "-P", sc["prefix"], "-t",
           str(sc["threshold"]), "--batch", str(sc["batch"]),
           "--identity-mode", sc["identity_mode"], "-o", paths["table"],
           "--timing-json", paths["timing"], "--device", device]
    if mix["input"] == "paf":
        out += ["--paf", inputs["paf"], "--fasta", inputs["fasta"]]
    else:
        out += ["--geno-dir", inputs["tiles"]]
    for path in inputs["panels"]:
        out += ["--panel", path]
    if sc.get("ehh"):
        out.append("--ehh")
    if sc.get("afs"):
        out += ["--afs", paths["afs"], "--afs-bins", str(sc["afs_bins"])]
    return out


def _check_row(t: Tally, truth: WindowTruth, w: Window, cells: List[str],
               col: Dict[str, int], exact: bool, full: bool) -> None:
    if not exact:
        return
    where = truth.region(w)
    f = truth.facts(w)
    due = [("LENGTH", w[1] - w[0]), ("SAMPLES", f["n"]),
           ("SEGREGATING_SITES", f["s"])]
    if truth.ehh:
        due += [("EHH_FOCAL", f["focal_pos"]),
                ("EHH_CARR_REF", f["carriers"][0]),
                ("EHH_CARR_ALT", f["carriers"][1])]
    for name, want in due:
        if cells[col[name]] != str(want):
            t.bad(f"{where} {name} {cells[col[name]]} against {want}")
    if not full:
        return
    st = truth.stats(w)
    length = w[1] - w[0]
    for p, lab in enumerate(truth.labels):
        t.float_cell("stat_gap", cells[col[f"PI_{lab}"]],
                     st["pi"][p] / length, where)
        t.float_cell("tajd_gap", cells[col[f"TAJD_{lab}"]], st["tajd"][p],
                     where)
    for q, (a, b) in enumerate(truth.pairs):
        tag = f"{truth.labels[a]}_{truth.labels[b]}"
        for key in ("fst", "fstg", "fst3"):
            t.float_cell("stat_gap", cells[col[f"{key.upper()}_{tag}"]],
                         st[key][q], where)
    if truth.ehh:
        t.float_cell("ehh_gap", cells[col["EHH_AREA_REF"]], st["ehh"][0],
                     where, relative=True)
        t.float_cell("ehh_gap", cells[col["EHH_AREA_ALT"]], st["ehh"][1],
                     where, relative=True)


def _check_afs(t: Tally, truth: WindowTruth, call: Call) -> None:
    want = np.zeros((len(truth.labels), truth.bins + 1), np.int64)
    for w in call.windows:
        want += truth.afs(w)
    got = np.zeros_like(want)
    with open(call.afs) as fh:
        head = fh.readline().split()
        if head != ["ALLELE_COUNT"] + [f"SITES_{n}" for n in truth.labels]:
            t.bad(f"spectrum header {head}")
            return
        for ln in fh:
            parts = [int(v) for v in ln.split()]
            got[:, parts[0]] = parts[1:]
    n_bad = int((got[:, 1:] != want[:, 1:]).sum())
    for _ in range(n_bad):
        t.bad(f"{call.afs}: spectrum counts differ")


def judge(truth: WindowTruth, calls: Sequence[Call], sample: Sequence[Window],
          check_all_rows: bool = True) -> Tuple[Dict[str, float], List[str]]:
    """(numbers, notes on the first wrong cells) over ``calls``: every
    row's region, the floats of the windows in ``sample``, the exact cells
    of every row when ``check_all_rows``, else of the sampled windows'
    rows."""
    full = set(sample)
    t = judge_tables(truth, calls, lambda t, w, cells, col: _check_row(
        t, truth, w, cells, col, check_all_rows or w in full, w in full))
    for call in calls:
        if call.error is None and call.afs is not None:
            _check_afs(t, truth, call)
    numbers = {"rows_wrong": float(t.wrong),
               "stat_gap": t.gap.get("stat_gap", 0.0),
               "tajd_gap": t.gap.get("tajd_gap", 0.0)}
    if truth.ehh:
        numbers["ehh_gap"] = t.gap.get("ehh_gap", 0.0)
    return numbers, t.notes


def _cell(v: float, fmt: str) -> str:
    return "NA" if math.isnan(v) else format(v, fmt)


def reference_table(truth: WindowTruth, windows, path: str,
                    full=None) -> None:
    """The scan's table for ``windows`` from ``truth``'s statistics, with
    the scan's columns and number formats; windows outside ``full`` (when
    given) get their exact cells only, and 0 in every float cell."""
    labs = truth.labels
    head = ["REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES"]
    for lab in labs:
        head += [f"PI_{lab}", f"TAJD_{lab}"]
    for a, b in truth.pairs:
        tag = f"{labs[a]}_{labs[b]}"
        head += [f"FST_{tag}", f"FSTG_{tag}", f"FST3_{tag}"]
    if truth.ehh:
        head += ["EHH_FOCAL", "EHH_AREA_REF", "EHH_CARR_REF", "EHH_AREA_ALT",
                 "EHH_CARR_ALT"]
    lines = ["\t".join(head)]
    for w in windows:
        f = truth.facts(w)
        length = w[1] - w[0]
        cells = [truth.region(w), str(length), str(f["n"]), str(f["s"])]
        if full is not None and w not in full:
            cells += ["0"] * (2 * len(labs) + 3 * len(truth.pairs))
            if truth.ehh:
                c = f["carriers"]
                cells += [str(f["focal_pos"]), "0", str(c[0]), "0", str(c[1])]
            lines.append("\t".join(cells))
            continue
        st = truth.stats(w)
        for p in range(len(labs)):
            cells += [format(st["pi"][p] / length, ".8f"),
                      _cell(st["tajd"][p], ".6f")]
        for q in range(len(truth.pairs)):
            cells += [format(st["fst"][q], ".8f"),
                      format(st["fstg"][q], ".8f"),
                      _cell(st["fst3"][q], ".8f")]
        if truth.ehh:
            e = st["ehh"]
            cells += [str(f["focal_pos"]), format(e[0], ".6f"), str(e[2]),
                      format(e[1], ".6f"), str(e[3])]
        lines.append("\t".join(cells))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")

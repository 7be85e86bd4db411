"""Trend plots (the port's copy of ``impop_tpu/report/plots.py``): a
matplotlib port of the reference R scripts' semantics.

plot_pi_trend.R / plot_fst_trend.R / plot_tajd_trend.R (reference C14-C16)
share one chassis: read one or more result tables, parse REGION into
chrom/start/end, lay windows on a concatenated multi-chromosome axis with
per-chromosome offsets (plot_pi_trend.R:237-256), draw one line+points per
labelled input, shade highlight intervals in gold (plot_pi_trend.R:393-427).
π uses a log10 y-axis by default with a linear opt-out
(plot_pi_trend.R:118-122); Fst and Tajima's D are linear; Tajima drops NA
rows (plot_tajd_trend.R:273).
"""
from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["plot_trend", "read_table_rows"]

_REGION_RE = re.compile(r"^(?:.*#)?(?P<chrom>[^:#]+):(?P<start>\d+)-(?P<end>\d+)$")


def _parse_region(text: str) -> Optional[Tuple[str, int, int]]:
    m = _REGION_RE.match(text)
    if not m:
        return None
    return m.group("chrom"), int(m.group("start")), int(m.group("end"))


def read_table_rows(path: str, kind: str) -> List[dict]:
    """Parse a result table into rows with chrom/start/end/value[/label].

    pi   : value = first token of PICA_OUTPUT (plot_pi_trend.R:218), label
           from SUBSET when present (plot_pi_trend.R:220-226)
    fst  : value = FST column, "NA"/"" -> NaN (plot_fst_trend.R:206-208)
    tajd : value = TAJIMAS_D with the full 6-column schema required
           (plot_tajd_trend.R:185), NA filtered by caller
    """
    rows: List[dict] = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        cols = {c: i for i, c in enumerate(header)}
        if "REGION" not in cols:
            raise ValueError(f"{path}: missing REGION column")
        if kind == "pi" and "PICA_OUTPUT" not in cols:
            raise ValueError(f"{path}: missing PICA_OUTPUT column")
        if kind == "fst" and "FST" not in cols:
            raise ValueError(f"{path}: missing FST column")
        if kind == "tajd":
            needed = {"REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES",
                      "PI", "TAJIMAS_D"}
            if not needed.issubset(cols):
                raise ValueError(
                    f"{path}: tajd table needs columns {sorted(needed)}"
                )
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < len(cols):
                continue
            parsed = _parse_region(parts[cols["REGION"]])
            if parsed is None:
                continue
            chrom, start, end = parsed
            if kind == "pi":
                token = parts[cols["PICA_OUTPUT"]].split()[0]
                label = parts[cols["SUBSET"]] if "SUBSET" in cols else None
            elif kind == "fst":
                token = parts[cols["FST"]]
                label = None
            else:
                token = parts[cols["TAJIMAS_D"]]
                label = None
            try:
                value = float("nan") if token in ("NA", "") else float(token)
            except ValueError:
                value = float("nan")
            rows.append({"chrom": chrom, "start": start, "end": end,
                         "value": value, "label": label})
    return rows


def _chrom_sort_key(chrom: str):
    m = re.match(r"^chr(\d+)$", chrom)
    return (0, int(m.group(1))) if m else (1, chrom)


def _compute_offsets(all_rows: List[dict],
                     gap: int = 500_000) -> Dict[str, int]:
    """Concatenated genome axis offsets with the reference's inter-chromosome
    gap (plot_pi_trend.R:237-256, gap = 5e5)."""
    spans: Dict[str, int] = {}
    for r in all_rows:
        spans[r["chrom"]] = max(spans.get(r["chrom"], 0), r["end"])
    offsets: Dict[str, int] = {}
    cum = 0
    for chrom in sorted(spans, key=_chrom_sort_key):
        offsets[chrom] = cum
        cum += spans[chrom] + gap
    return offsets


def _format_bp(bp: float) -> str:
    """Axis tick label in the reference's Mb/kb style
    (plot_pi_trend.R format_bp_value)."""
    if bp >= 1e6:
        return f"{bp / 1e6:.2f} Mb"
    if bp >= 1e3:
        return f"{bp / 1e3:.0f} kb"
    return f"{bp:.0f}"


def plot_trend(args) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kind = args.kind
    inputs: List[Tuple[str, str]] = []
    for item in args.input:
        if "=" in item:
            label, path = item.split("=", 1)
        else:
            label, path = "", item
        inputs.append((label, path))
    if args.input_dir:
        for name in sorted(os.listdir(args.input_dir)):
            path = os.path.join(args.input_dir, name)
            if os.path.isfile(path):
                inputs.append(("", path))
    if not inputs:
        print("error: no --input tables given", file=sys.stderr)
        return 1

    series: List[Tuple[str, List[dict]]] = []
    for label, path in inputs:
        rows = read_table_rows(path, kind)
        if not label:
            subs = {r["label"] for r in rows if r.get("label")}
            label = subs.pop() if len(subs) == 1 else os.path.basename(path)
        series.append((label, rows))

    all_rows = [r for _, rows in series for r in rows]
    offsets = _compute_offsets(all_rows)

    fig, ax = plt.subplots(figsize=(12, 5), dpi=args.dpi)
    for label, rows in series:
        xs, ys = [], []
        for r in rows:
            if kind == "tajd" and np.isnan(r["value"]):
                continue  # plot_tajd_trend.R:273
            mid = (r["start"] + r["end"]) / 2 + offsets[r["chrom"]]
            xs.append(mid)
            ys.append(r["value"])
        order = np.argsort(xs)
        xs = np.asarray(xs)[order]
        ys = np.asarray(ys)[order]
        ax.plot(xs, ys, marker="o", markersize=3, linewidth=1, label=label)

    # per-chromosome axis furniture (plot_pi_trend.R:343-352, 390-391,
    # 461-464, 495-496): local Mb tick labels within each chromosome's
    # span, dashed vlines at chromosome boundaries
    spans: Dict[str, Tuple[int, int]] = {}
    for r in all_rows:
        lo, hi = spans.get(r["chrom"], (r["start"], r["end"]))
        spans[r["chrom"]] = (min(lo, r["start"]), max(hi, r["end"]))
    tick_pos: List[float] = []
    tick_lab: List[str] = []
    axis_span = max(
        (spans[c][1] + offsets[c]) for c in spans
    ) - min((spans[c][0] + offsets[c]) for c in spans) or 1
    for chrom in sorted(spans, key=_chrom_sort_key):
        lo, hi = spans[chrom]
        off = offsets[chrom]
        # chromosomes occupying a sliver of the concatenated axis get only
        # their boundary ticks (interior labels would collide)
        frac = (hi - lo) / axis_span
        local = np.linspace(lo, hi, num=4 if frac > 0.2 else 2)
        for bp in local:
            tick_pos.append(bp + off)
            tick_lab.append(f"{bp / 1e6:.2f}")
    ax.set_xticks(tick_pos)
    ax.set_xticklabels(tick_lab, fontsize=7, rotation=30, ha="right")
    for chrom in sorted(spans, key=_chrom_sort_key):
        if offsets[chrom] != 0:
            ax.axvline(offsets[chrom], color="0.8", linestyle="--",
                       linewidth=0.6, zorder=0)
    if len(spans) > 1:
        # chromosome name centred under its span (the multi-chromosome
        # concatenated-axis labelling of the R chassis)
        for chrom in spans:
            lo, hi = spans[chrom]
            mid = (lo + hi) / 2 + offsets[chrom]
            ax.annotate(chrom, xy=(mid, 0), xycoords=("data", "axes fraction"),
                        xytext=(0, -28), textcoords="offset points",
                        ha="center", fontsize=9, color="0.3")

    # gold highlight rectangles + labels (plot_pi_trend.R:393-427)
    highlights: List[Tuple[str, int, int]] = []
    for text in args.highlight:
        parsed = _parse_region(text)
        if parsed:
            highlights.append(parsed)
    if args.highlight_bed:
        from impop_tpu_torch.io.bed import read_bed

        for reg in read_bed(args.highlight_bed):
            highlights.append((reg.chrom, reg.start, reg.end))
    for chrom, start, end in highlights:
        off = offsets.get(chrom, 0)
        x0 = start + off
        x1 = max(end, start + 1) + off
        ax.axvspan(x0, x1, color="gold", alpha=0.35, zorder=0)
        # "chrom:start-end Mb" text above the rect (plot_pi_trend.R:419-423)
        ax.annotate(
            f"{chrom}:{start / 1e6:.2f}-{end / 1e6:.2f} Mb",
            xy=((x0 + x1) / 2, 1.0), xycoords=("data", "axes fraction"),
            xytext=(0, 4), textcoords="offset points",
            ha="center", fontsize=8, color="0.25", clip_on=False,
        )

    if kind == "pi" and not args.linear_y:
        ax.set_yscale("log")  # plot_pi_trend.R log10 default
        ax.set_ylabel("pi per site (log10)")
    elif kind == "pi":
        ax.set_ylabel("pi per site")
    elif kind == "fst":
        ax.set_ylabel("Fst")
    else:
        ax.set_ylabel("Tajima's D")
    chroms = sorted(spans, key=_chrom_sort_key)
    if len(chroms) == 1:
        ax.set_xlabel(f"Genomic Position (Mb, {chroms[0]})")
    else:
        ax.set_xlabel("Genomic Position (Mb)")

    default_titles = {"pi": "Nucleotide diversity trend",
                      "fst": "Fst trend", "tajd": "Tajima's D trend"}
    ax.set_title(args.title or default_titles[kind])
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()

    default_out = {"pi": "pi_trend.png", "fst": "fst_trend.png",
                   "tajd": "tajd_trend.png"}
    out = args.output or default_out[kind]
    fig.savefig(out, dpi=args.dpi)
    plt.close(fig)
    print(f"wrote {out}", file=sys.stderr)
    return 0

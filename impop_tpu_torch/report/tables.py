"""Output tables with schemas identical to the reference scripts.

Headers and cell formats are copied contracts (not code): a downstream
consumer of the reference's TSVs — including its own R plot scripts — must be
able to read ours unchanged.

  pi     : REGION [SUBSET] LENGTH THRESHOLD R_VALUE PICA_OUTPUT
           (run_pica2_impg.sh:119-123)
  h-fst  : REGION LENGTH FST PI_A PI_B PI_XY DXY DA        (run_h-fst.sh:148)
  3-pi   : REGION LENGTH THRESHOLD R_VALUE PI_A PI_B PI_C PI_AB_AVG FST
           (run_fst_impg.sh:158)
  tajd   : REGION LENGTH SAMPLES SEGREGATING_SITES PI TAJIMAS_D
           (run_tajd.sh:101)
"""
from __future__ import annotations

import math
from typing import Optional

HFST_HEADER = "REGION\tLENGTH\tFST\tPI_A\tPI_B\tPI_XY\tDXY\tDA"
FST3PI_HEADER = (
    "REGION\tLENGTH\tTHRESHOLD\tR_VALUE\tPI_A\tPI_B\tPI_C\tPI_AB_AVG\tFST"
)
TAJD_HEADER = "REGION\tLENGTH\tSAMPLES\tSEGREGATING_SITES\tPI\tTAJIMAS_D"
AFS_HEADER = "cluster_id\tcount\tfrequency"


def pi_table_header(with_subset: bool) -> str:
    if with_subset:
        return "REGION\tSUBSET\tLENGTH\tTHRESHOLD\tR_VALUE\tPICA_OUTPUT"
    return "REGION\tLENGTH\tTHRESHOLD\tR_VALUE\tPICA_OUTPUT"


def format_pica_output(pi: float, pi_per_site: Optional[float],
                       sequence_length: Optional[int]) -> str:
    """pica2.py's stdout contract (pica2.py:225-228): per-site at 8 dp when a
    length is given, else raw π at 6 dp; the '(sequence length: …)' suffix is
    part of the PICA_OUTPUT cell the batch scripts capture verbatim
    (run_pica2_impg.sh:182)."""
    if sequence_length:
        return f"{pi_per_site:.8f} (sequence length: {sequence_length})"
    return f"{pi:.6f} (sequence length: {sequence_length})"


def pi_row(region: str, subset_label: Optional[str], length: int,
           threshold: float, r_value: Optional[int], pica_output: str) -> str:
    r_txt = "" if r_value is None else r_value
    if subset_label is not None:
        return f"{region}\t{subset_label}\t{length}\t{threshold}\t{r_txt}\t{pica_output}"
    return f"{region}\t{length}\t{threshold}\t{r_txt}\t{pica_output}"


def hfst_row(region: str, length: int, fst: float, pi_a: float, pi_b: float,
             pi_xy: float, dxy: float, da: float) -> str:
    """h-fst.py's six 8-dp fields (h-fst.py:338-339) prefixed by
    region/length (run_h-fst.sh:91)."""
    return (
        f"{region}\t{length}\t{fst:.8f}\t{pi_a:.8f}\t{pi_b:.8f}\t"
        f"{pi_xy:.8f}\t{dxy:.8f}\t{da:.8f}"
    )


def fst3pi_row(region: str, length: int, threshold: float, r_value: Optional[int],
               pi_a: float, pi_b: float, pi_c: float) -> str:
    """run_fst_impg.sh row, reproducing its quantise-through-text pipeline:
    each π is formatted at 8 dp (pica2 stdout), re-parsed, and πAB/Fst are
    computed from the *formatted* values (run_fst_impg.sh:199-218)."""
    pa_s, pb_s, pc_s = f"{pi_a:.8f}", f"{pi_b:.8f}", f"{pi_c:.8f}"
    pa, pb, pc = float(pa_s), float(pb_s), float(pc_s)
    pi_ab = 0.5 * (pa + pb)
    fst_s = "NA" if pc == 0 else f"{(pc - pi_ab) / pc:.8f}"
    r_txt = "" if r_value is None else r_value
    return (
        f"{region}\t{length}\t{threshold}\t{r_txt}\t{pa_s}\t{pb_s}\t{pc_s}\t"
        f"{pi_ab:.8f}\t{fst_s}"
    )


def tajd_row(region: str, length: int, samples: int, s_count: int,
             pi_per_site: float, d: float) -> str:
    """run_tajd.sh:196 — PI is pica2's 8-dp per-site value; NaN D prints NA
    (run_tajd.sh:192-194)."""
    d_txt = "NA" if (d is None or (isinstance(d, float) and math.isnan(d))) else f"{d}"
    return f"{region}\t{length}\t{samples}\t{s_count}\t{pi_per_site:.8f}\t{d_txt}"


def afs_summary_rows(clusters) -> list[str]:
    """af.py cluster summary (af.py:56-61): cluster_id, count, frequency."""
    total = sum(len(c) for c in clusters)
    rows = []
    for idx, members in enumerate(clusters, 1):
        freq = (len(members) / total) if total else 0.0
        rows.append(f"c{idx}\t{len(members)}\t{freq:.6f}")
    return rows

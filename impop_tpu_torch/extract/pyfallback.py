"""Pure-Python window projection — fallback and C++ oracle.

Implements exactly the semantics of cpp/window.cc (PAF+CIGAR walk → variant
calls → allele matrix) so environments without a compiler still extract, and
the C++ path has an independent reference to test against.
"""
from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from impop_tpu_torch.extract import WindowMatrix

__all__ = ["PyExtractor", "read_fasta", "parse_paf", "fetch_fasta_window"]

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def read_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, str] = {}
    name = None
    chunks: List[str] = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


@dataclass
class PafRec:
    query_name: str
    query_len: int
    query_start: int
    query_end: int
    reverse: bool
    target_name: str
    target_start: int
    target_end: int
    cigar: List[Tuple[int, str]] = field(default_factory=list)


def parse_paf(path: str) -> List[PafRec]:
    recs: List[PafRec] = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 12:
                continue
            cigar: List[Tuple[int, str]] = []
            for tag in cols[12:]:
                if tag.startswith("cg:Z:"):
                    cigar = [(int(m.group(1)), m.group(2))
                             for m in _CIGAR_RE.finditer(tag[5:])]
            recs.append(PafRec(
                cols[0], int(cols[1]), int(cols[2]), int(cols[3]),
                cols[4] == "-", cols[5], int(cols[7]), int(cols[8]), cigar,
            ))
    return recs


class PyExtractor:
    def __init__(self, paf_path: str, fasta_path: str):
        self.recs = parse_paf(paf_path)
        self.seqs = read_fasta(fasta_path)

    def extract(self, target: str, start: int, end: int) -> WindowMatrix:
        if end <= start:
            raise ValueError("empty window")
        tseq = self.seqs.get(target, "")

        def target_base(pos: int) -> str:
            off = pos
            if 0 <= off < len(tseq):
                return tseq[off].upper()
            return "N"

        haps: Dict[str, dict] = {}

        for rec in self.recs:
            if rec.target_name != target or not rec.cigar:
                continue
            if rec.target_end <= start or rec.target_start >= end:
                continue
            qfull = self.seqs.get(rec.query_name)
            have_q = qfull is not None
            qseq = ""
            if have_q:
                qseq = qfull[rec.query_start:rec.query_end]
                if rec.reverse:
                    qseq = revcomp(qseq)

            def qbase(qi: int) -> str:
                if not have_q or qi < 0 or qi >= len(qseq):
                    return "N"
                return qseq[qi].upper()

            row_name = f"{rec.query_name}:{rec.query_start}-{rec.query_end}"
            hap = haps.setdefault(row_name, {
                "cover_start": float("inf"), "cover_end": float("-inf"),
                "variants": set(),
            })
            tpos, qi = rec.target_start, 0
            hap["cover_start"] = min(hap["cover_start"], max(start, tpos))
            for length, op in rec.cigar:
                if tpos >= end and op != "I":
                    break
                if op == "=":
                    tpos += length; qi += length
                elif op == "M":
                    for k in range(length):
                        p = tpos + k
                        if start <= p < end and have_q:
                            tb, qb = target_base(p), qbase(qi + k)
                            if tb != qb and tb != "N" and qb != "N":
                                hap["variants"].add((p, tb, qb))
                    tpos += length; qi += length
                elif op == "X":
                    for k in range(length):
                        p = tpos + k
                        if start <= p < end:
                            hap["variants"].add(
                                (p, target_base(p), qbase(qi + k))
                            )
                    tpos += length; qi += length
                elif op == "I":
                    if start < tpos <= end:
                        alt = (qseq[qi:qi + length].upper() if have_q
                               else f"<INS{length}>")
                        hap["variants"].add((tpos, "", alt))
                    qi += length
                elif op in ("D", "N"):
                    del_start, del_end = max(tpos, start), min(tpos + length, end)
                    if op == "D" and del_start < del_end:
                        ref = "".join(target_base(p)
                                      for p in range(del_start, del_end))
                        hap["variants"].add((del_start, ref, ""))
                    tpos += length
                elif op == "S":
                    qi += length
                elif op == "H":
                    pass
                else:
                    tpos += length; qi += length
            hap["cover_end"] = max(hap["cover_end"], min(end, tpos))

        ref_name = f"{target}:{start}-{end}"
        haps[ref_name] = {"cover_start": start, "cover_end": end,
                          "variants": set()}

        all_vars = sorted({v for h in haps.values() for v in h["variants"]})
        col_of = {v: i for i, v in enumerate(all_vars)}
        names = sorted(haps)
        n, s = len(names), len(all_vars)
        geno = np.full((n, max(s, 1)), -1, dtype=np.int8)
        site_pos = np.asarray([v[0] for v in all_vars], dtype=np.int64)
        for row, name in enumerate(names):
            hap = haps[name]
            for c, v in enumerate(all_vars):
                # insertion columns (empty ref) sit between bases: covered
                # iff cover_start < pos <= cover_end
                if v[1] == "":
                    covered = hap["cover_start"] < v[0] <= hap["cover_end"]
                else:
                    covered = hap["cover_start"] <= v[0] < hap["cover_end"]
                if covered:
                    geno[row, c] = 0
            for v in hap["variants"]:
                geno[row, col_of[v]] = 1
        geno = geno[:, :s] if s else geno[:, :0]
        site_keys = [f"{p}:{r}>{a}" for p, r, a in all_vars]
        return WindowMatrix(names, site_keys, site_pos, geno)


def fetch_fasta_window(path: str, name: str, start: int, end: int) -> str:
    """Random-access FASTA slice via the .fai index (builds none; falls back
    to a full parse when no index exists)."""
    import os

    fai = path + ".fai"
    if os.path.exists(fai):
        with open(fai) as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                if len(cols) >= 5 and cols[0] == name:
                    length, offset, lb, lw = (int(cols[1]), int(cols[2]),
                                              int(cols[3]), int(cols[4]))
                    start = max(0, start)
                    end = min(end, length)
                    if start >= end:
                        return ""
                    out = []
                    with open(path, "rb") as f:
                        pos = start
                        while pos < end:
                            li, ci = divmod(pos, lb)
                            take = min(lb - ci, end - pos)
                            f.seek(offset + li * lw + ci)
                            out.append(f.read(take).decode())
                            pos += take
                    return "".join(out)
    seqs = read_fasta(path)
    return seqs.get(name, "")[start:end]

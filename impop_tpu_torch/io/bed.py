"""BED windows and region strings.

The reference iterates BED rows in bash (`while read chr start end`,
run_pica2_impg.sh:126) and builds region strings ``<prefix><chr>:<start>-<end>``
with prefix de-duplication (run_pica2_impg.sh:139-151).  It generates windows
by shelling out to ``bedtools makewindows`` (doc/how_pi.md:42).  Both live
here as plain functions.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Union

__all__ = ["Region", "read_bed", "make_windows", "parse_region"]


@dataclasses.dataclass(frozen=True)
class Region:
    chrom: str
    start: int
    end: int
    name: Optional[str] = None

    @property
    def length(self) -> int:
        return self.end - self.start

    def region_string(self, prefix: str = "") -> str:
        """Build ``<prefix><chrom>:<start>-<end>``.

        Avoids doubling the prefix when the BED row already carries it
        (reference run_pica2_impg.sh:139-151).
        """
        if prefix and not self.chrom.startswith(prefix):
            return f"{prefix}{self.chrom}:{self.start}-{self.end}"
        return f"{self.chrom}:{self.start}-{self.end}"


def parse_region(text: str) -> Region:
    """Parse ``chrom:start-end`` (prefix kept inside chrom)."""
    chrom, _, span = text.rpartition(":")
    start_s, _, end_s = span.partition("-")
    if not chrom or not end_s:
        raise ValueError(f"cannot parse region string: {text!r}")
    return Region(chrom=chrom, start=int(start_s), end=int(end_s))


def read_bed(path: Union[str, os.PathLike]) -> List[Region]:
    """Read BED rows, skipping comments/blank rows and non-positive intervals
    with the same tolerance as the reference scripts
    (run_pica2_impg.sh:126-137, run_h-fst.sh:155-181)."""
    regions: List[Region] = []
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                continue
            chrom, start_s, end_s = parts[0], parts[1], parts[2]
            if not (start_s.isdigit() and end_s.isdigit()):
                continue
            start, end = int(start_s), int(end_s)
            if end - start <= 0:
                continue
            name = parts[3] if len(parts) > 3 and parts[3] else None
            regions.append(Region(chrom, start, end, name))
    return regions


def make_windows(
    chrom: str, start: int, end: int, window_size: int
) -> List[Region]:
    """Fixed-width tiling of [start, end) — the `bedtools makewindows -w`
    capability the reference depends on (doc/how_pi.md:42).  The final window
    is truncated at ``end``."""
    if window_size <= 0:
        raise ValueError("window_size must be positive")
    out: List[Region] = []
    pos = start
    while pos < end:
        out.append(Region(chrom, pos, min(pos + window_size, end)))
        pos += window_size
    return out

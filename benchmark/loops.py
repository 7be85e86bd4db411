"""The one traffic generator: a mix's parameters in, the calls of a run out.

Mixes (``benchmark/traffic/<mix>.json``):

- ``"command"``: the port's CLI command each call runs, found as
  ``benchmark/commands/<command>.py``.
- ``"loop": "passes"``: every call is one command over the configuration's
  region tiled into its windows, listed ``repeat`` times; calls run back to
  back (a closed loop of one client).
- ``"loop": "queries"``: every call is one command over one locus: a
  length from ``locus_bp`` (each block of ``len(locus_bp)`` queries holds
  every length once, in a seeded order) and a start drawn uniformly over
  the region, split into the configuration's windows.

``input`` names what the scan reads: ``"paf"`` (PAF + FASTA) or
``"tiles"`` (``--geno-dir`` allele tiles).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

from benchmark.datagen import rng_for

__all__ = ["tiled", "pass_windows", "warmup_calls", "query_stream",
           "write_bed", "call_paths"]

Window = Tuple[int, int]


def tiled(cfg: dict) -> List[Window]:
    """The region cut into the configuration's windows."""
    step = int(cfg["window_bp"])
    length = int(cfg["data"]["region_bp"])
    return [(lo, lo + step) for lo in range(0, length - step + 1, step)]


def pass_windows(cfg: dict, mix: dict) -> List[Window]:
    return tiled(cfg) * int(mix.get("repeat", 1))


def _locus(cfg: dict, start: int, span: int) -> List[Window]:
    step = int(cfg["window_bp"])
    return [(lo, lo + step) for lo in range(start, start + span, step)]


def query_stream(cfg: dict, mix: dict, seed: int) -> Iterator[List[Window]]:
    """Endless loci for a query mix, from ``seed``."""
    rng = rng_for(seed, 1)
    lengths = [int(v) for v in mix["locus_bp"]]
    region = int(cfg["data"]["region_bp"])
    while True:
        for span in rng.permutation(lengths).tolist():
            start = int(rng.integers(0, region - span + 1))
            yield _locus(cfg, start, span)


def warmup_calls(cfg: dict, mix: dict) -> List[List[Window]]:
    """The calls of the set-up's warm-up: each shape the mix's calls use,
    once (one short pass, or one locus of each length)."""
    if mix["loop"] == "passes":
        return [tiled(cfg)[:int(mix["warmup_windows"])]]
    return [_locus(cfg, 0, int(span)) for span in sorted(mix["locus_bp"])]


def write_bed(path: str, chrom: str, windows: List[Window]) -> str:
    with open(path, "w") as fh:
        fh.write("".join(f"{chrom}\t{lo}\t{hi}\n" for lo, hi in windows))
    return path


def call_paths(work: str, k: int) -> Dict[str, str]:
    """The files of call ``k``: its ``bed``, output ``table``, ``timing``
    JSON and ``afs`` spectrum."""
    d = os.path.join(work, "calls")
    os.makedirs(d, exist_ok=True)
    return {key: os.path.join(d, f"{k}.{ext}") for key, ext in (
        ("bed", "bed"), ("table", "tsv"), ("timing", "timing.json"),
        ("afs", "afs.tsv"))}

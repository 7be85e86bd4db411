"""Population-panel handling.

Reproduces the reference's identifier canonicalization and panel expansion
(reference scripts/h-fst.py:18-82): assembly names such as
``HG00097_hap1_hprc_r2_v1.0.1`` become prefixes ``HG00097#1#`` matched against
similarity-matrix sequence identifiers like
``HG00097#1#CM094061.1:109468899-109469099`` via startswith.
"""
from __future__ import annotations

import bisect
import os
from typing import Iterable, List, Sequence, Set, Tuple, Union

__all__ = [
    "canonicalize_identifier",
    "expand_population",
    "read_panel_file",
    "union_panel",
]

_SUFFIX_MAP = (
    ("_hap1", "#1#"),
    ("_hap2", "#2#"),
    ("_mat", "#1#"),
    ("_pat", "#2#"),
)


def canonicalize_identifier(identifier: str) -> str:
    """Map an assembly name to a sequence-name prefix.

    Semantics match reference h-fst.py:18-61:
      - strip everything from ``_hprc`` onward
      - ``_hap1``/``_mat`` -> ``#1#``; ``_hap2``/``_pat`` -> ``#2#``
      - identifiers already containing ``#`` are kept (``#``-terminated)
      - bare sample names match both haplotypes (``SAMPLE#``)
    """
    if not identifier:
        return ""
    token = identifier.strip()
    if not token or token.startswith("#"):
        return ""
    if "_hprc" in token:
        token = token.split("_hprc", 1)[0]
    for suffix, hap_tag in _SUFFIX_MAP:
        if token.endswith(suffix):
            return token[: -len(suffix)] + hap_tag
    if "#" in token:
        return token if token.endswith("#") else token + "#"
    return token + "#"


def expand_population(
    raw_ids: Iterable[str], all_sequences: Iterable[str]
) -> Tuple[Set[str], List[str]]:
    """Expand panel identifiers to concrete sequence names.

    Returns (matched sequence names, panel identifiers with no match),
    mirroring reference h-fst.py:64-82.  The names that start with a
    prefix are one run of the sorted names, found by binary search.
    """
    ranked = sorted(all_sequences)
    expanded: Set[str] = set()
    missing: List[str] = []
    for raw_id in raw_ids:
        prefix = canonicalize_identifier(raw_id)
        if not prefix:
            continue
        k = bisect.bisect_left(ranked, prefix)
        hit = k
        while hit < len(ranked) and ranked[hit].startswith(prefix):
            expanded.add(ranked[hit])
            hit += 1
        if hit == k:
            missing.append(raw_id)
    return expanded, missing


def read_panel_file(path: Union[str, os.PathLike]) -> List[str]:
    """Read a panel list: one identifier per line, '#' comments skipped.

    Matches reference h-fst.py:121-127 (read_subset_file) except the result
    preserves file order with duplicates removed (the reference's set gives
    arbitrary order; order only matters for our deterministic batching).
    """
    seen = set()
    out: List[str] = []
    with open(path) as handle:
        for line in handle:
            token = line.strip()
            if not token or token.startswith("#"):
                continue
            if token not in seen:
                seen.add(token)
                out.append(token)
    return out


def union_panel(list_a: Sequence[str], list_b: Sequence[str]) -> List[str]:
    """A ∪ B preserving first-seen order — the reference's union list
    construction (run_fst_impg.sh:146, ``awk 'NF && !seen[$0]++'``)."""
    seen = set()
    out: List[str] = []
    for token in list(list_a) + list(list_b):
        if token and token not in seen:
            seen.add(token)
            out.append(token)
    return out

"""Reader for the reference's pairwise-similarity TSV contract.

The reference's L1 layer (impg similarity / odgi similarity) emits a TSV with
header ``group.a  group.b  estimated.identity`` consumed row-by-row into a
dict keyed by unordered pair (reference scripts/pica2.py:6-58,
h-fst.py:84-119).  Here the same contract is ingested once into a dense
symmetric matrix plus a presence mask, which is the layout every estimator
in :mod:`impop_tpu_torch.stats` consumes.

Row order is the sorted unique identifier order; this is also the
deterministic seed order fixed by our grouping spec (see
stats/grouping.py — the reference's seed order is Python-set pop order,
pica2.py:100, which is not reproducible; sorted order is the documented
deterministic replacement).
"""
from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["SimilarityMatrix", "read_similarity_tsv", "round_half_even"]

_REQUIRED_COLS = ("group.a", "group.b", "estimated.identity")


_py_round = np.frompyfunc(round, 2, 1)


def round_half_even(values: np.ndarray, digits: int) -> np.ndarray:
    """Decimal rounding bit-identical to Python's built-in ``round()``.

    The reference rounds similarities with Python's ``round`` (pica2.py:83,
    h-fst.py:150), which uses correctly-rounded decimal semantics;
    ``np.round``'s scale-round-unscale can differ on representation ties, and
    these values feed strict threshold comparisons — so we apply the Python
    rounding elementwise.  Host-side ingest only (O(n²) per window, ~ms).
    """
    arr = np.asarray(values, dtype=np.float64)
    return _py_round(arr, digits).astype(np.float64)


@dataclasses.dataclass
class SimilarityMatrix:
    """Dense symmetric similarity matrix for one window.

    Attributes:
      names:   sorted unique sequence identifiers (row/col order)
      sim:     [n, n] float64, symmetric; diagonal = 1.0; 0 where absent
      present: [n, n] bool, True where the input provided this pair
               (diagonal True by convention)
      pair_count: number of data rows parsed (reference pica2.py pair_count)
    """

    names: List[str]
    sim: np.ndarray
    present: np.ndarray
    pair_count: int

    @property
    def n(self) -> int:
        return len(self.names)

    def index(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.names)}

    def rounded(self, digits: Optional[int]) -> "SimilarityMatrix":
        """Return a copy with similarities decimal-rounded (round-half-even)."""
        if digits is None:
            return self
        return SimilarityMatrix(
            names=self.names,
            sim=round_half_even(self.sim, digits),
            present=self.present,
            pair_count=self.pair_count,
        )

    def mask_for(self, names: Sequence[str]) -> np.ndarray:
        """Boolean row mask selecting the given sequence names."""
        idx = self.index()
        mask = np.zeros(self.n, dtype=bool)
        for name in names:
            i = idx.get(name)
            if i is not None:
                mask[i] = True
        return mask


def _parse_rows(handle) -> Tuple[List[Tuple[str, str, float]], int]:
    header = handle.readline().rstrip("\n")
    if not header:
        raise ValueError("similarity file is empty or missing a header")
    cols = header.split("\t")
    col_idx = {}
    for required in _REQUIRED_COLS:
        if required not in cols:
            raise ValueError(
                f"similarity file must contain columns {list(_REQUIRED_COLS)}; "
                f"found {cols}"
            )
        col_idx[required] = cols.index(required)
    ia, ib, iv = (col_idx[c] for c in _REQUIRED_COLS)
    width = max(ia, ib, iv) + 1

    rows: List[Tuple[str, str, float]] = []
    n_bad = 0
    for line in handle:
        line = line.rstrip("\n")
        if not line:
            continue
        parts = line.split("\t")
        if len(parts) < width:
            n_bad += 1
            continue
        try:
            val = float(parts[iv])
        except ValueError:
            # reference h-fst.py:108 warns and skips invalid rows
            n_bad += 1
            continue
        rows.append((parts[ia], parts[ib], val))
    return rows, n_bad


def read_similarity_tsv(
    source: Union[str, os.PathLike, _io.TextIOBase],
    round_digits: Optional[int] = None,
) -> SimilarityMatrix:
    """Read a ``group.a / group.b / estimated.identity`` TSV into a matrix.

    Later duplicate rows overwrite earlier ones for the same unordered pair,
    matching the reference's dict assignment (pica2.py:44).
    """
    if hasattr(source, "readline"):
        rows, _ = _parse_rows(source)
    else:
        with open(source, "r", newline="") as handle:
            rows, _ = _parse_rows(handle)

    names = sorted({r[0] for r in rows} | {r[1] for r in rows})
    index = {name: i for i, name in enumerate(names)}
    n = len(names)

    sim = np.zeros((n, n), dtype=np.float64)
    present = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(present, True)
    np.fill_diagonal(sim, 1.0)

    for a, b, val in rows:
        i, j = index[a], index[b]
        sim[i, j] = val
        sim[j, i] = val
        present[i, j] = True
        present[j, i] = True

    mat = SimilarityMatrix(names=names, sim=sim, present=present, pair_count=len(rows))
    return mat.rounded(round_digits)


def write_similarity_tsv(mat: SimilarityMatrix, path: Union[str, os.PathLike]) -> None:
    """Write the upper triangle back out in the reference TSV contract."""
    with open(path, "w") as out:
        out.write("group.a\tgroup.b\testimated.identity\n")
        for i in range(mat.n):
            for j in range(i + 1, mat.n):
                if mat.present[i, j]:
                    out.write(f"{mat.names[i]}\t{mat.names[j]}\t{mat.sim[i, j]}\n")

"""The pure-Python estimators of the reference's semantics, for the
measurement entry points of the port (``bench/main.py``'s ``vs_baseline``,
``bench/check_device_oracle.py``).

A copy of the dict-based functions of the repository's test oracle
(``tests/oracle.py``): greedy grouping with the sorted seed order, pica2
π, Hudson direct and grouped Fst, Tajima's D.  Inputs are a similarity
dict {(a, b) sorted tuple: float} plus element sets, as the reference
scripts hold them in memory.  ``tests/test_torch_bench.py`` holds every
function here to its original.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Pair = Tuple[str, str]


def _key(a: str, b: str) -> Pair:
    return (a, b) if a <= b else (b, a)


def _get(similarities: Dict[Pair, float], a: str, b: str,
         round_digits: Optional[int]) -> Optional[float]:
    val = similarities.get(_key(a, b))
    if val is not None and round_digits is not None:
        val = round(val, round_digits)
    return val


def greedy_groups(
    similarities: Dict[Pair, float],
    elements: Iterable[str],
    threshold: float,
    round_digits: Optional[int] = None,
) -> List[List[str]]:
    """Greedy one-hop grouping with deterministic sorted seed order."""
    remaining = sorted(set(elements))
    groups: List[List[str]] = []
    while remaining:
        current = remaining.pop(0)
        group = [current]
        kept = []
        for other in remaining:
            sim = _get(similarities, current, other, round_digits)
            if sim is not None and sim > threshold:
                group.append(other)
            else:
                kept.append(other)
        remaining = kept
        groups.append(sorted(group))
    groups.sort()
    return groups


def pica2_pi(
    similarities: Dict[Pair, float],
    elements: Iterable[str],
    threshold: float,
    round_digits: Optional[int] = None,
    sequence_length: Optional[int] = None,
) -> Tuple[float, Optional[float]]:
    """π with pica2 semantics (rounding -> grouping -> rep pairs -> Bessel)."""
    if round_digits is not None:
        similarities = {k: round(v, round_digits) for k, v in similarities.items()}
        round_digits = None
    groups = greedy_groups(similarities, elements, threshold)
    total = sum(len(g) for g in groups)
    if total == 0:
        return 0.0, 0.0 if sequence_length else None
    pairs = []
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            sim = _get(similarities, groups[i][0], groups[j][0], None)
            if sim is None:
                continue
            pairs.append((1 - sim) * (len(groups[i]) / total) * (len(groups[j]) / total))
    if not pairs:
        return 0.0, 0.0 if sequence_length else None
    n = total
    pi = (n / (n - 1)) * sum(2 * p for p in pairs)
    return pi, (pi / sequence_length if sequence_length else None)


def direct_diversity(
    similarities: Dict[Pair, float],
    set1: Sequence[str],
    set2: Optional[Sequence[str]] = None,
    round_digits: Optional[int] = None,
) -> Tuple[float, int, int]:
    values = []
    missing = 0
    if set2 is None:
        lst = sorted(set1)
        for i in range(len(lst)):
            for j in range(i + 1, len(lst)):
                sim = _get(similarities, lst[i], lst[j], round_digits)
                if sim is None:
                    missing += 1
                else:
                    values.append(1 - sim)
    else:
        for a in set1:
            for b in set2:
                sim = _get(similarities, a, b, round_digits)
                if sim is None:
                    missing += 1
                else:
                    values.append(1 - sim)
    if not values:
        return 0.0, 0, missing
    return sum(values) / len(values), len(values), missing


def hudson_fst_direct(
    similarities: Dict[Pair, float],
    pop_a: Sequence[str],
    pop_b: Sequence[str],
    round_digits: Optional[int] = None,
) -> Dict[str, float]:
    pa = set(pop_a)
    pb = set(pop_b)
    overlap = pa & pb
    pa -= overlap
    pb -= overlap
    pi_a, _, _ = direct_diversity(similarities, pa, round_digits=round_digits)
    pi_b, _, _ = direct_diversity(similarities, pb, round_digits=round_digits)
    dxy, _, _ = direct_diversity(similarities, pa, pb, round_digits=round_digits)
    pi_xy = 0.5 * (pi_a + pi_b)
    fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
    return {"fst": fst, "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
            "dxy": dxy, "da": dxy - pi_xy}


def _first_pair_sim(
    similarities: Dict[Pair, float],
    group1: Sequence[str],
    group2: Sequence[str],
    round_digits: Optional[int],
) -> Optional[float]:
    for a in group1:
        for b in group2:
            sim = _get(similarities, a, b, round_digits)
            if sim is not None:
                return sim
    return None


def hud_grouped_diversity(
    similarities: Dict[Pair, float],
    sequences: Sequence[str],
    threshold: float,
    round_digits: Optional[int] = None,
) -> Tuple[float, int, int]:
    groups = greedy_groups(similarities, sequences, threshold, round_digits)
    n = len(set(sequences))
    if n <= 1:
        return 0.0, len(groups), 0
    total = 0.0
    missing = 0
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            sim = _first_pair_sim(similarities, groups[i], groups[j], round_digits)
            if sim is None:
                missing += 1
            else:
                total += 2 * (len(groups[i]) / n) * (len(groups[j]) / n) * (1 - sim)
    return total * n / (n - 1), len(groups), missing


def hud_grouped_dxy(
    similarities: Dict[Pair, float],
    pop_a: Sequence[str],
    pop_b: Sequence[str],
    threshold: float,
    round_digits: Optional[int] = None,
) -> float:
    groups_a = greedy_groups(similarities, pop_a, threshold, round_digits)
    groups_b = greedy_groups(similarities, pop_b, threshold, round_digits)
    n_a, n_b = len(set(pop_a)), len(set(pop_b))
    total = 0.0
    for ga in groups_a:
        for gb in groups_b:
            sim = _first_pair_sim(similarities, ga, gb, round_digits)
            if sim is not None:
                total += (len(ga) * len(gb)) / (n_a * n_b) * (1 - sim)
    return total


def hudson_fst_grouped(
    similarities: Dict[Pair, float],
    pop_a: Sequence[str],
    pop_b: Sequence[str],
    threshold: float,
    round_digits: Optional[int] = None,
) -> Dict[str, float]:
    pa = sorted(set(pop_a) - (set(pop_a) & set(pop_b)))
    pb = sorted(set(pop_b) - (set(pop_a) & set(pop_b)))
    pi_a, _, _ = hud_grouped_diversity(similarities, pa, threshold, round_digits)
    pi_b, _, _ = hud_grouped_diversity(similarities, pb, threshold, round_digits)
    dxy = hud_grouped_dxy(similarities, pa, pb, threshold, round_digits)
    pi_xy = 0.5 * (pi_a + pi_b)
    fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
    return {"fst": fst, "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
            "dxy": dxy, "da": dxy - pi_xy}


def tajimas_d(n: int, s: float, pi: float) -> float:
    if n < 2:
        raise ValueError("n must be >= 2")
    a1 = sum(1.0 / i for i in range(1, n))
    a2 = sum(1.0 / (i * i) for i in range(1, n))
    b1 = (n + 1.0) / (3.0 * (n - 1.0))
    b2 = 2.0 * (n * n + n + 3.0) / (9.0 * n * (n - 1.0))
    c1 = b1 - 1.0 / a1
    c2 = b2 - (n + 2.0) / (a1 * n) + a2 / (a1 * a1)
    e1 = c1 / a1
    e2 = c2 / (a1 * a1 + a2)
    num = pi - s / a1
    den = math.sqrt(e1 * s + e2 * s * (s - 1.0)) if s > 0 else float("nan")
    if not den or math.isnan(den) or math.isclose(den, 0.0):
        return float("nan")
    return num / den

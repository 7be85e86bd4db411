"""The program's own spans and counters in a run's calls (``scan
--timing-json``: ``spans`` as rows of ``span_fields``, ``counters``).

A program that records none (a checkout before them) reads None here, so
the metrics built on them drop out of its line.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["span_sums", "counter", "per_call"]


def span_sums(run, name: str) -> Optional[Tuple[int, int, int]]:
    """(spans, wall ns, CPU ns) of the spans ``name`` over the run's calls
    (a span that did not read its CPU time adds none); None when no call
    recorded spans."""
    n = wall = cpu = 0
    seen = False
    for c in run.calls:
        rows = c.timing.get("spans")
        if rows is None:
            continue
        seen = True
        f = {k: i for i, k in enumerate(c.timing["span_fields"])}
        for r in rows:
            if r[f["name"]] == name:
                n += 1
                wall += r[f["end_ns"]] - r[f["start_ns"]]
                cpu += r[f["cpu_ns"]] or 0
    return (n, wall, cpu) if seen else None


def per_call(run, name: str) -> List[int]:
    """Counter ``name`` of each call that counted it, in call order."""
    return [c.timing["counters"][name] for c in run.calls
            if name in c.timing.get("counters", {})]


def counter(run, name: str) -> Optional[int]:
    """Counter ``name`` summed over the run's calls; None when no call
    counted it."""
    got = per_call(run, name)
    return sum(got) if got else None

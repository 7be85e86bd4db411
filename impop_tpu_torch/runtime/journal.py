"""Per-window result journal with idempotent resume.

The same on-disk JSON-lines format as ``impop_tpu/runtime/journal.py``
(one ``{"region": ..., **payload}`` record per completed or failed window),
so a scan begun by either package resumes in the other.  It is a copy, not
an import: importing ``impop_tpu.runtime`` loads ``jax`` (its package
``__init__`` imports the batcher).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["ResultJournal"]


class ResultJournal:
    """Append-only JSONL journal of per-window results."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._records: Dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as handle:
                for line in handle:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write from a killed run
                    key = rec.get("region")
                    if key:
                        self._records[key] = rec

    def record(self, region: str, payload: dict) -> None:
        self.record_many([(region, payload)])

    def record_many(self, records: Iterable[Tuple[str, dict]]) -> None:
        """Append ``(region, payload)`` records in their order with one
        open and one write; nothing without a file."""
        if self.path:
            with open(self.path, "a") as handle:
                handle.write("".join(
                    json.dumps({"region": region, **payload}) + "\n"
                    for region, payload in records))

    def record_failure(self, region: str, reason: str) -> None:
        self.record(region, {"status": "NA", "reason": reason})

    def get(self, region: str) -> Optional[dict]:
        """The region's record as the file held it when the journal was
        opened: what a resumed scan replays."""
        return self._records.get(region)

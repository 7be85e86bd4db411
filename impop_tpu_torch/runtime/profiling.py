"""Per-stage timing and device tracing.

- :class:`StageTimers` — wall-clock accumulation per pipeline stage
  (setup / extract / build / h2d / device / fetch / emit), copied from
  ``impop_tpu/runtime/profiling.py`` because importing ``impop_tpu.runtime``
  loads ``jax``.  Stages are host-clock spans: ``device`` measures the
  enqueue of a batch's kernels, and ``fetch`` (the device-to-host copy) is
  the barrier that waits for them.
- :func:`device_trace` — a ``torch.profiler`` trace of CPU and CUDA
  activity, written as a Chrome trace into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

__all__ = ["StageTimers", "device_trace"]


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.samples: Dict[str, list] = {}
        self.windows = 0
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.samples.setdefault(name, []).append(dt)

    def add_windows(self, n: int) -> None:
        self.windows += n

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def to_json(self) -> dict:
        """Machine-readable stage breakdown with per-call samples."""
        return {
            "windows": self.windows,
            "elapsed_sec": self.elapsed(),
            "stages": {
                name: {
                    "total_sec": self.totals[name],
                    "calls": self.counts[name],
                    "samples_sec": self.samples[name],
                }
                for name in self.totals
            },
        }

    def report(self) -> str:
        elapsed = time.perf_counter() - self._start
        lines = [f"elapsed {elapsed:.2f}s, windows {self.windows}"
                 + (f" ({self.windows / elapsed:.1f}/s)" if elapsed > 0
                    else "")]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"  {name:10s} {total:8.2f}s total  {count:5d} calls  "
                f"{total / max(count, 1) * 1e3:8.1f} ms/call"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace (CPU, plus CUDA when available) written to
    ``trace_dir/trace.json``; no-op without a directory."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

"""The traced run: a ``torch.profiler`` session over the measured window
and its reduction to device busy time, kernel time by name and the idle
gaps by what the host was doing.

The benchmark marks the window (``bench:window``) and every call
(``bench:call``), and while tracing it also marks each of the program's
``StageTimers`` stages (``stage:<name>``) by wrapping
``StageTimers.stage``: the stages' own timing is unchanged.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
from typing import Iterator, List, Tuple

__all__ = ["Trace", "profiled", "annotate", "read_trace"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def annotate(name: str, on: bool) -> Iterator[None]:
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def _stage_marks() -> Iterator[None]:
    import torch
    from impop_tpu_torch.runtime.profiling import StageTimers

    original = StageTimers.stage

    @contextlib.contextmanager
    def stage(self, name):
        with torch.profiler.record_function(f"stage:{name}"), \
                original(self, name):
            yield

    StageTimers.stage = stage
    try:
        yield
    finally:
        StageTimers.stage = original


@contextlib.contextmanager
def profiled(path: str) -> Iterator[None]:
    """Profile CPU and CUDA activity, then write the Chrome trace to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with _stage_marks():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
    prof.export_chrome_trace(path)


def _short(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces
    and its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """Device activity and host marks inside the measured window (µs in
    the trace's clock)."""

    def __init__(self, events: List[dict]) -> None:
        win = [e for e in events if e.get("name") == "bench:window"
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("trace has no bench:window mark")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device: List[Tuple[str, float, float]] = []
        self.marks: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b <= a:
                continue
            if e.get("cat") in _DEVICE_CATS:
                self.device.append((_short(e["name"]), a, b))
            elif e.get("cat") == "user_annotation" and (
                    e["name"].startswith("stage:")
                    or e["name"] == "bench:call"):
                self.marks.append((e["name"], a, b))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        return sum(b - a for a, b in
                   _union([(a, b) for _, a, b in self.device])) * 1e-6

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose names contain one of
        ``names``."""
        return sum(b - a for n, a, b in self.device
                   if any(k in n for k in names)) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        by = collections.Counter()
        for n, a, b in self.device:
            by[n] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the device summed by what the host was doing at
        each gap's middle: the stage marks open there, or ``between
        calls``."""
        busy = _union([(a, b) for _, a, b in self.device])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        # sweep the gaps' middles through the marks' starts and ends
        bounds = sorted([(s, 1, n) for n, s, _ in self.marks]
                        + [(e, -1, n) for n, _, e in self.marks])
        active: collections.Counter = collections.Counter()
        by: collections.Counter = collections.Counter()
        i = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(bounds) and bounds[i][0] <= mid:
                active[bounds[i][2]] += bounds[i][1]
                i += 1
            open_ = sorted(n for n, c in active.items()
                           if c > 0 and n != "bench:call")
            label = ("+".join(open_) if open_ else "call, no stage"
                     if active["bench:call"] > 0 else "between calls")
            by[label] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(top)]


def read_trace(path: str) -> Trace:
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    trace = Trace(events)
    os.remove(path)
    return trace

"""The scan's span recorder and device tracing.

- :class:`StageTimers` — the program's spans and counters.  A span is one
  stage of the pipeline (setup / extract / build / h2d / wait_input /
  device / fetch / emit, and their parts) on one thread, with its batch
  (chunk ``k`` of the call), its parent (the span open on the same thread
  when it opened), its wall in ``time.perf_counter_ns()`` and, where asked
  for, the thread's CPU time over it (``time.thread_time_ns()``).  Every
  span also adds its wall to its stage's total and count.  Stages are
  host-clock spans: ``device`` times the enqueue of a batch's step, and
  ``fetch`` (the device-to-host copy) is the barrier that waits for it.
- :func:`span` / :func:`count` — record into the recorder bound to the
  calling thread (:meth:`StageTimers.bind`), for library code such as the
  scan's step; with no recorder bound they do nothing (tracing off: one
  thread-local lookup).
- :func:`device_trace` — a ``torch.profiler`` trace of CPU and CUDA
  activity, written as a Chrome trace into a directory, with the
  recorder's spans of every thread appended on the trace's clock.

While a ``torch.profiler`` session records the calling thread, each span
also opens ``torch.profiler.record_function("stage:<name>")``, so the
main thread's spans are marks of the device trace.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["StageTimers", "span", "count", "device_trace", "SPAN_FIELDS"]

# The thread's CPU clock is a system call, where the wall clock is not:
# on an H100 host it took 2.5 µs a read, and reading it at every span of
# the scan (about twenty reads a batch, the interpreter lock held) cost
# several percent of the scan's rate.  So a span reads it only when asked
# (``cpu=True``): the scan asks at the spans whose CPU time is read.

# the fields of one row of ``spans`` in StageTimers.to_json
SPAN_FIELDS = ("id", "name", "thread", "batch", "parent", "start_ns",
               "end_ns", "cpu_ns")

_bound = threading.local()      # .rec: the calling thread's recorder


def _profiling():
    """A function that says whether a ``torch.profiler`` session records
    the calling thread (one C call)."""
    import torch

    return torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("rec", "name", "batch", "cpu", "id", "parent", "stack",
                 "mark", "t0", "c0")

    def __init__(self, rec: "StageTimers", name: str, batch: Optional[int],
                 cpu: bool) -> None:
        self.rec, self.name, self.batch, self.cpu = rec, name, batch, cpu

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.stack = stack = rec._thread()[1]
        self.id = next(rec._ids)
        if stack:
            self.parent, parent_batch = stack[-1]
            if self.batch is None:
                self.batch = parent_batch
        else:
            self.parent = None
        stack.append((self.id, self.batch))
        # Each clock is read just before the mark's call: a torch op lets
        # go of the interpreter lock and takes its timestamp at once, but
        # taking the lock back after it can wait for another thread (or a
        # first entry's set-up) for milliseconds, so a clock read after
        # the call would fall that much later than the mark's edge.
        self.mark = None
        if rec._profiling():
            from torch.profiler import record_function

            self.mark = record_function("stage:" + self.name)
        self.t0 = time.perf_counter_ns()
        if self.cpu:
            self.c0 = time.thread_time_ns()
        if self.mark is not None:
            self.mark.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        cpu = time.thread_time_ns() - self.c0 if self.cpu else None
        t1 = time.perf_counter_ns()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        self.stack.pop()
        self.rec._close(self, t1, cpu)


class StageTimers:
    """The spans, stage totals and counters of one command."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.spans: List[tuple] = []        # closed spans, SPAN_FIELDS
        self.windows = 0
        self._start = time.perf_counter()
        # the two clocks read together: perf_counter_ns + (unix_ns -
        # perf_ns) is a span's Unix time; of a few readings the one whose
        # Unix read the two perf reads bracket closest (a thread switched
        # out between them would shift every span)
        brackets = []
        for _ in range(5):
            p0 = time.perf_counter_ns()
            unix = time.time_ns()
            p1 = time.perf_counter_ns()
            brackets.append((p1 - p0, (p0 + p1) // 2, unix))
        _, perf, unix = min(brackets)
        self.clock = {"perf_ns": perf, "unix_ns": unix}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._threads: Dict[int, tuple] = {}    # ident -> (label, stack)
        self._profiling = _profiling()

    def _thread(self) -> tuple:
        """(label, stack of open spans) of the calling thread, which
        :meth:`bind` bound to this recorder."""
        return self._threads[threading.get_ident()]

    def _close(self, s: _Span, t1: int, cpu: Optional[int]) -> None:
        self.spans.append((s.id, s.name, self._thread()[0], s.batch,
                           s.parent, s.t0, t1, cpu))
        with self._lock:
            self.totals[s.name] = (self.totals.get(s.name, 0.0)
                                   + (t1 - s.t0) * 1e-9)
            self.counts[s.name] = self.counts.get(s.name, 0) + 1

    def bind(self, thread: str) -> None:
        """Make this the recorder of the calling thread for :func:`span`
        and :func:`count`, its spans labelled ``thread`` (a pool's
        ``initializer``: the binding lasts the thread's life)."""
        _bound.rec = self
        self._threads[threading.get_ident()] = (thread, [])

    @contextlib.contextmanager
    def bound(self, thread: str) -> Iterator["StageTimers"]:
        """:meth:`bind` for the block; the calling thread's earlier
        recorder, if any, is bound again after it."""
        before = getattr(_bound, "rec", None)
        self.bind(thread)
        try:
            yield self
        finally:
            _bound.rec = before

    def stage(self, name: str) -> _Span:
        """A span of stage ``name`` on the calling thread, which is bound
        to this recorder (a context manager)."""
        return _Span(self, name, None, False)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def add_windows(self, n: int) -> None:
        self.windows += n

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def to_json(self) -> dict:
        """Machine-readable record: stage totals and counts, the spans
        (rows of ``span_fields``, by id), the counters and the clock
        anchor."""
        return {
            "windows": self.windows,
            "elapsed_sec": self.elapsed(),
            "stages": {
                name: {"total_sec": self.totals[name],
                       "calls": self.counts[name]}
                for name in self.totals
            },
            "span_fields": list(SPAN_FIELDS),
            "spans": [list(s) for s in sorted(self.spans)],
            "counters": dict(self.counters),
            "clock": dict(self.clock),
        }

    def trace_events(self, base_ns: int, since_ns: int = 0) -> List[dict]:
        """The spans that end at or after ``since_ns`` (perf_counter_ns)
        as Chrome trace events on a trace whose ``ts`` (µs) counts from
        Unix time ``base_ns``: one ``tid`` per thread, named by metadata
        events, with batch, parent and CPU time in ``args``."""
        pid = os.getpid()
        shift = self.clock["unix_ns"] - self.clock["perf_ns"] - base_ns
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for sid, name, thread, batch, parent, t0, t1, cpu in sorted(
                self.spans):
            if t1 < since_ns:
                continue
            if thread not in tids:
                tids[thread] = tid = 1_000_000_000 + len(tids)
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid,
                               "args": {"name": f"spans {thread}"}})
            events.append({"name": name, "cat": "program_span", "ph": "X",
                           "pid": pid, "tid": tids[thread],
                           "ts": (t0 + shift) / 1e3, "dur": (t1 - t0) / 1e3,
                           "args": {"id": sid, "batch": batch,
                                    "parent": parent, "cpu_ns": cpu}})
        return events

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


def span(name: str, batch: Optional[int] = None, cpu: bool = False):
    """A span of ``name`` in the recorder bound to the calling thread (a
    context manager); a no-op when none is bound.  ``batch`` defaults to
    the parent span's; ``cpu`` reads the thread's CPU time over it (else
    its ``cpu_ns`` is None)."""
    rec = getattr(_bound, "rec", None)
    return (contextlib.nullcontext() if rec is None
            else _Span(rec, name, batch, cpu))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the recorder bound to the calling
    thread; nothing when none is bound."""
    rec = getattr(_bound, "rec", None)
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str],
                 timers: StageTimers) -> Iterator[None]:
    """torch.profiler trace (CPU, plus CUDA when available) written to
    ``trace_dir/trace.json``, with ``timers``' spans of every thread that
    end inside the session appended; no-op without a directory."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with profile(activities=acts) as prof:
        since = time.perf_counter_ns()
        yield
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        return
    doc["traceEvents"] += timers.trace_events(int(base), since)
    with open(path, "w") as fh:
        json.dump(doc, fh)

"""Measurement scripts for the port's kernels (run on a CUDA card)."""
from __future__ import annotations

import statistics

__all__ = ["graph_ms"]


def graph_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one fn() on the card alone: fn captured once
    in a CUDA graph (after a warm-up call on a side stream) and the graph
    replayed between CUDA events, so the host's launch overhead is not
    timed.  fn must not synchronise."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)

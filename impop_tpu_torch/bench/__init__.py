"""Measurement scripts for the port's kernels (run on a CUDA card)."""
from __future__ import annotations

import statistics

__all__ = ["graph_ms", "build_variants"]


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


def build_variants(source: str, variants: dict, work: str) -> dict:
    """{name: ctypes.CDLL} of ``csrc/<source>`` rebuilt once per variant:
    each variant is a list of (old, new) text substitutions on the
    source, all in flight at once (one nvcc per variant) into ``work``.
    Raises when the source no longer holds a substitution's text or a
    build fails.  The caller sets the entry points' argtypes."""
    import ctypes
    import os
    import subprocess

    from impop_tpu_torch.ops._build import _CSRC, NVCC_FLAGS, nvcc_path

    with open(os.path.join(_CSRC, source)) as fh:
        src = fh.read()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", _CSRC, "-shared", "-o",
             os.path.join(work, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(work, f"{name}.so"))
    return libs

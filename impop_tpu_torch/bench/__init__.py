"""Measurement scripts for the port's kernels (run on a CUDA card)."""
from __future__ import annotations

import statistics

__all__ = ["graph_ms", "build_variants", "variant_texts"]


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


def variant_texts(source: str, subs) -> dict:
    """{file name: text} of ``csrc/<source>`` and of the ``csrc/*.cuh``
    headers after the (old, new) substitutions ``subs``: each applies to
    the source when it holds ``old``, else to the one header that does.
    Raises when no file holds a substitution's text."""
    import glob
    import os

    from impop_tpu_torch.ops._build import _CSRC

    names = [source] + sorted(os.path.basename(h) for h in
                              glob.glob(os.path.join(_CSRC, "*.cuh")))
    texts = {}
    for name in names:
        with open(os.path.join(_CSRC, name)) as fh:
            texts[name] = fh.read()
    for old, new in subs:
        where = [n for n in names if old in texts[n]]
        if not where:
            raise RuntimeError(f"no kernel source holds {old!r}")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def build_variants(source: str, variants: dict, work: str,
                   extra: tuple = ()) -> dict:
    """{name: ctypes.CDLL} of ``csrc/<source>`` rebuilt once per variant:
    each variant is a list of (old, new) text substitutions on the source
    or a header it includes (``variant_texts``), all in flight at once (one
    nvcc per variant, each in a directory of its own under ``work`` with
    its edited files first on the include path), linked with the
    unchanged ``csrc/<extra>`` sources it calls into.  Raises when no
    source holds a substitution's text or a build fails.  The caller sets
    the entry points' argtypes."""
    import ctypes
    import os
    import subprocess

    from impop_tpu_torch.ops._build import _CSRC, NVCC_FLAGS, nvcc_path

    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(work, name)
        os.makedirs(vdir)
        for fname, text in variant_texts(source, subs).items():
            with open(os.path.join(vdir, fname), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", vdir, "-I", _CSRC, "-shared",
             "-o", os.path.join(vdir, f"{name}.so"), os.path.join(vdir, source),
             *(os.path.join(_CSRC, e) for e in extra)],
            cwd=vdir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(work, name, f"{name}.so"))
    return libs

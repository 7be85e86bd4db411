"""Scan set-up, the C++ share of the extractor's open: the wall of the
native open (``ix_open``: the PAF index, from its sidecar or parsed, and
the FASTA index; counter ``open.native_ns``) per call, in ms, inside the
``setup.open`` span."""
from benchmark.spans import counter


def read(run):
    ns = counter(run, "open.native_ns")
    return 1e-6 * ns / len(run.calls) if ns is not None else None

"""Scan set-up: native extractors left open per call, from the gauge
``extractors.open`` (the extractors open in the process at a call's
open): its rise from the window's first call to its last, over the calls
between.  A scan that closes its extractor reads 0; one that leaves it
open reads 1."""
from benchmark.spans import per_call


def read(run):
    got = per_call(run, "extractors.open")
    return (got[-1] - got[0]) / (len(got) - 1) if len(got) > 1 else None

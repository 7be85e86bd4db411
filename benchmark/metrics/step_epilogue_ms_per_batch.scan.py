"""Scan step (``scanstep.scan_step``): the wall of the ``step.epilogue``
spans (Tajima's D, the Fst assembly, 3-π, the row's concatenation) per
``device`` span (batch), in ms: the epilogue's share of the enqueue."""
from benchmark.spans import span_sums


def read(run):
    epi, dev = span_sums(run, "step.epilogue"), span_sums(run, "device")
    return 1e-6 * epi[1] / dev[0] if epi and epi[0] and dev[0] else None

"""Scan step (``scanstep.scan_step``, columns mode with --ehh --afs): the
wall of the ``step.groups`` spans, inside ``step.stats``, per ``device``
span (batch), in ms: the grouping and the masked sums
(``stats.panelstats.fused_panel_stats``: ``ops/seedpeel`` and
``ops/panelquad``).  The host's enqueue, not the device's time; a scan
without the option, or a program that does not record the span, drops the
metric out of its line."""
from benchmark.spans import span_sums


def read(run):
    part, dev = span_sums(run, "step.groups"), span_sums(run, "device")
    return (1e-6 * part[1] / dev[0] if part and part[0] and dev and dev[0]
            else None)

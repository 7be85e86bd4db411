"""Scan step (``scanstep.scan_step``, columns mode with --ehh --afs): the
wall of the ``step.ehh`` spans, inside ``step.epilogue``, per ``device``
span (batch), in ms: the EHH decay areas (``stats.ehh.ehh_area_dynamic``:
``ops/ehhdeath``).  The host's enqueue, not the device's time; a scan
without the option, or a program that does not record the span, drops the
metric out of its line."""
from benchmark.spans import span_sums


def read(run):
    part, dev = span_sums(run, "step.ehh"), span_sums(run, "device")
    return (1e-6 * part[1] / dev[0] if part and part[0] and dev and dev[0]
            else None)

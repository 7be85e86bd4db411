"""Drain (``cli.drain``, with --afs): the wall of the ``emit.afs`` spans,
one a window inside ``emit`` (the window's sparse spectrum, its sum into
the genome-wide spectrum and its journal entry), per ``emit`` span
(batch), in ms.  A scan without --afs, or a program that
does not record the span, drops the metric out of its line."""
from benchmark.spans import span_sums


def read(run):
    part, emit = span_sums(run, "emit.afs"), span_sums(run, "emit")
    return (1e-6 * part[1] / emit[0] if part and part[0] and emit and emit[0]
            else None)

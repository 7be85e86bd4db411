"""Scan step (``scanstep.scan_step``): the main thread's CPU time over the
``device`` spans per batch, in ms.  Beside the spans' wall
(``step_enqueue_ms_per_batch.scan``), the difference is time the main
thread spent off the CPU: waiting for the GIL or blocked."""
from benchmark.spans import span_sums


def read(run):
    got = span_sums(run, "device")
    return 1e-6 * got[2] / got[0] if got and got[0] else None

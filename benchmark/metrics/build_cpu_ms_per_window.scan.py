"""Host pack (``cli.prepare_native``): the pack worker's CPU time over the
``build`` spans per emitted window, in ms, beside their wall
(``build_ms_per_window.scan``)."""
from benchmark.spans import span_sums


def read(run):
    got = span_sums(run, "build")
    return 1e-6 * got[2] / run.rows if got and got[0] and run.rows else None

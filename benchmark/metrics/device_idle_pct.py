"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card, in %, from the profiler's trace."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.window_s else None

"""windows_per_s: windows whose rows the calls emitted, over all the time
from the start of the measured window to the end of the last call (the
call in flight when the window's seconds ran out finishes and counts)."""


def read(run):
    return run.rows / run.window_s

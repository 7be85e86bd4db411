"""Host extract, the C++ share: the walls of the native extractor's batch
calls (counter ``extract.native_ns``; ctypes lets go of the interpreter
lock for a call, so its wall is native time, with the wait to take the
lock back) per emitted window, in ms, inside the ``extract`` spans of
``extract_ms_per_window.scan``."""
from benchmark.spans import counter


def read(run):
    ns = counter(run, "extract.native_ns")
    return 1e-6 * ns / run.rows if ns is not None and run.rows else None

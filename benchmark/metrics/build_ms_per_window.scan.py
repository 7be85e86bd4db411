"""Host pack (``cli.prepare_native`` / ``prepare_tiles``,
``hostio.pack_scan_batch``): the ``build`` stage per emitted window, in ms
(busy time of the pack worker thread; ``build.pack`` is inside it)."""


def read(run):
    return run.ms_per_window("build")

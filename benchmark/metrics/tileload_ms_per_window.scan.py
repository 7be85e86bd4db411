"""Host tile load (``hostio.GenoSource`` via ``cli.load_chunk``): the
``extract`` stage of a ``--geno-dir`` scan per emitted window, in ms (busy
time of the extract worker thread)."""


def read(run):
    return run.ms_per_window("extract")

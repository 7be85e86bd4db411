"""Host extraction (``impop_tpu_torch.extract`` via ``cli.extract_native``):
the ``extract`` stage's seconds per emitted window, in ms.  The stage runs
on the extract worker thread, so it is busy time, not a share of the
wall."""


def read(run):
    return run.ms_per_window("extract")

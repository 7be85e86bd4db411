"""Host extraction of a locus query: the ``extract`` stage per query, in
ms."""


def read(run):
    return run.ms_per_call("extract")

"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the kernels' and extractor's builds (cached after the first run),
the inputs made from the seed, and one warm-up call of each shape."""


def read(run):
    return run.setup_s

"""Scan set-up (``cli.cmd_scan``: the BED, the extractor's open, the five
panel files): the ``setup.bed``, ``setup.open`` and ``setup.panels``
stages per query, in ms."""


def read(run):
    return run.ms_per_call("setup.bed", "setup.open", "setup.panels")

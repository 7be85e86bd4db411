"""Drain (``cli.drain``): the device-to-host copy of a batch's rows and the
host's wait for the device (the ``fetch`` stage) per batch, in ms."""


def read(run):
    return run.ms_per_stage_call("fetch")

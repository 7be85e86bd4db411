"""Scan step (``scanstep.scan_step``: wire decode, kernels and epilogue):
host seconds to enqueue one batch (the ``device`` stage), in ms.  It times
the host's enqueue, not the device."""


def read(run):
    return run.ms_per_stage_call("device")

"""Scan loop (``cli.cmd_scan``): the share of the calls' wall in which the
main thread waited for the input pipeline (``wait_input``), in %."""


def read(run):
    wall = sum(run.walls)
    return 100.0 * run.stage("wait_input") / wall if wall else None

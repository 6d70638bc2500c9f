"""Seconds from the process's start to the first timed call: imports,
loading (on a checkout's first run, building) the kernels, the warm
call."""


def read(run):
    return run.setup_s

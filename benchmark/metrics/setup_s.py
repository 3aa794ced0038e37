"""Seconds from the process's start to the window's: making the inputs,
loading (on a checkout's first run, building) the kernels, the warm-up."""


def read(run):
    return run.setup_s

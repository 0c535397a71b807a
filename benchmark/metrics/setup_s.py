"""Seconds from the process's start to the window's: importing, the
data, the program's set-up, building the kernels where they are not
built yet, and the warm-up queries."""


def read(run):
    return run.setup_s

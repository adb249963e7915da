"""Seconds from the start of the process to the start of the window:
imports, the kernel libraries (built on a checkout's first run), the data,
the index and one warm request."""


def read(run):
    return run.setup_s

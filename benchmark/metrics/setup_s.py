"""Seconds from the start of the process to the start of the window:
imports, the kernel library, the host build and the warm-up."""


def read(run):
    return run.setup_s

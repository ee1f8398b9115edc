"""Seconds from the process's start to the window's opening (host clock):
imports, inputs, weights, the kernel library, the warm-up."""


def read(run):
    return run.setup_s

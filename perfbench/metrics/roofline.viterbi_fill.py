"""Kernel C's share of its roofline in the traced window: the least time
for the work the window's reads need (perfbench/counts.py) over the
kernel's device seconds in the profiler's trace."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "C")

"""Milliseconds of the prep stage (events, scaling, banded fill and chase,
Theil-Sen) per kbp processed: the program's StageTimer, summed over the
worker threads."""

from perfbench.readers import stage_ms_per_kbp


def read(run):
    return stage_ms_per_kbp(run, "prep")

"""Milliseconds of the eventalign stage (windows, Viterbi fill and
backtrace, post-processing) per kbp processed: the program's StageTimer."""

from perfbench.readers import stage_ms_per_kbp


def read(run):
    return stage_ms_per_kbp(run, "eventalign")

"""Milliseconds of the CNN stage per kbp processed: the program's
StageTimer stage cnn_forward."""

from perfbench.readers import stage_ms_per_kbp


def read(run):
    return stage_ms_per_kbp(run, "cnn")

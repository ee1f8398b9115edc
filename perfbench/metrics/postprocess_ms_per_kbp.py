"""Milliseconds of eventalign's native window post-processing per kbp
processed: the benchmark's span around native.process_read_windows."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "postprocess", "kbp")

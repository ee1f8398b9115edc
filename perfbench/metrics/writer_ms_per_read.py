"""Milliseconds of ModBamWriter.write a read (MM/ML tags, BGZF deflate):
the benchmark's span around each write."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "writer", "call")

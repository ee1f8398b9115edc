"""Milliseconds a read spends in the signal source's next() (BAM record,
CIGAR maps, pod5 VBZ decode), on the pipeline's producer thread: the
benchmark's span around each next()."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "source", "call")

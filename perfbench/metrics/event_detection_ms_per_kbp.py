"""Milliseconds of native event detection per kbp processed: the
benchmark's span around prep.detect_events."""

from perfbench.readers import span_ms


def read(run):
    return span_ms(run, "event_detection", "kbp")

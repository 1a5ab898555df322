"""Median over the quiet stretch's decode ticks (span log on, profiler
off) of the ``tick`` span: the host's time to enqueue one tick (the
forward and its sampling), ms."""
from portbench import spanslice


def read(ctx):
    return spanslice.median_span(ctx, "tick", "decode_burst", 1e6)

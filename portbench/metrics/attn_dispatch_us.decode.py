"""Median over the quiet stretch's decode ticks (span log on, profiler
off) of one layer's ``attn`` span (its norm, q/k/v/o, rope, paged
cache write and attention), us."""
from portbench import spanslice


def read(ctx):
    return spanslice.median_span(ctx, "attn", "tick", 1e3)

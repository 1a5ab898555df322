"""Median over the quiet stretch's decode ticks (span log on, profiler
off) of one layer's ``ffn`` span (the FFN hook: three block-sparse
projections and the gating), us."""
from portbench import spanslice


def read(ctx):
    return spanslice.median_span(ctx, "ffn", "tick", 1e3)

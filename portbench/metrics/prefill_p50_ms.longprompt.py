"""Median over the requests sent and finished in the window of the engine's
first-token time minus its admission time (its chunked prefill among the
decode bursts), ms."""
from portbench import readers


def read(ctx):
    return readers.prefill_p50_ms(ctx)

"""Median over the requests sent and finished in the window of (last token
- first token) / (tokens - 1), ms."""
from portbench import readers


def read(ctx):
    return readers.ms_p(readers.tpot(ctx), 50)

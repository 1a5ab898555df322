"""Median over the window's decode bursts of burst seconds / ticks, ms."""
from portbench import readers


def read(ctx):
    return readers.tick_ms(ctx)

"""Median over the requests sent and finished in the window of the time
from the client's send to its first token, ms."""
from portbench import readers


def read(ctx):
    return readers.ms_p(readers.ttft(ctx), 50)

"""The traced slice's roofline-bound time of all its work (prefill chunks
and decode ticks) over its wall time, %."""
from portbench import readers


def read(ctx):
    return readers.step_share(ctx)

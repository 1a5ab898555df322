"""The traced slice's roofline-bound time of all its work (decode ticks and
prefill chunks) over its wall time, %."""
from portbench import readers


def read(ctx):
    return readers.step_share(ctx)

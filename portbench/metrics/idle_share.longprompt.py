"""1 - the union of device-busy intervals / the traced slice's wall time."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)

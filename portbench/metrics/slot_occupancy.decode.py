"""Mean over the window's decode bursts of active slots / max_slots."""
from portbench import readers


def read(ctx):
    return readers.occupancy(ctx)

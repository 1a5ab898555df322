"""Device memory allocated once the weights, the plans and the engine are
built, before the KV pool, GiB."""
from portbench import readers


def read(ctx):
    return None if ctx["weight_bytes"] is None else ctx["weight_bytes"] / readers.GIB

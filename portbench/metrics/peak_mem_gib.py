"""torch.cuda.max_memory_allocated from the start of the run to the
window's end, GiB."""
from portbench import readers


def read(ctx):
    return None if ctx["peak_bytes"] is None else ctx["peak_bytes"] / readers.GIB

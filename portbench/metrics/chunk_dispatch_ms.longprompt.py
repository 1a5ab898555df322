"""Median over the quiet stretch's prefill chunks (span log on, profiler
off) of the ``prefill_chunk`` span less its ``sample_first`` child
(which holds the chunk's sync): the host's time to enqueue one chunk,
ms."""
from portbench import spanslice


def read(ctx):
    return spanslice.chunk_dispatch_ms(ctx)

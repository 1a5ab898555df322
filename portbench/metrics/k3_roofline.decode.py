"""Kernel 3 (paged_attention_*) in the decode bursts of the traced slice: bound seconds
of its calls there over its device seconds there, %."""
from portbench import readers


def read(ctx):
    return readers.kernel_share(ctx, "k3", readers.k3_bound, "decode")

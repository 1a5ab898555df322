"""Kernel 1 (block_sparse_kernel) in the decode bursts of the traced slice: bound seconds
of its calls there over its device seconds there, %."""
from portbench import readers


def read(ctx):
    return readers.kernel_share(ctx, "k1", readers.k1_bound, "decode")

"""Kernel 6 (grouped_kernel) in the prefill chunks of the traced slice: bound seconds
of its calls there over its device seconds there, %."""
from portbench import readers


def read(ctx):
    return readers.kernel_share(ctx, "k6", readers.k6_bound, "prefill")

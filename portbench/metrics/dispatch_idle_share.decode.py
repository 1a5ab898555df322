"""Idle device seconds of the profiled stretch whose gap ends in work
launched inside a ``tick`` span, over the stretch's wall."""
from portbench import spanslice


def read(ctx):
    return spanslice.dispatch_idle_share(ctx)

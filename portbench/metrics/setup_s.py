"""Seconds from the process's start to the window's start: imports,
weights, plans, engine, kernel builds, warm-up and the first wave's
prefill."""


def read(ctx):
    return ctx["setup_s"]

"""Output tokens delivered in the window over the window (every token event
the clients got inside it)."""


def read(ctx):
    return ctx["window_tokens"] / ctx["seconds"]

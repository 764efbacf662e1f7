"""Queries of the calls completed in the window over the wall seconds from
the window's start to the end of the last of those calls (host clock)."""


def read(ctx):
    return ctx["queries"] / ctx["window_s"] if ctx["queries"] else None

"""The benchmark's span around `format_results` over the window, per query,
in ms."""


def read(ctx):
    s = ctx["spans"].get("format")
    return None if s is None or not ctx["queries"] else 1e3 * s / ctx["queries"]

"""The program's `host_loop` stage seconds (STAGE_TIMES) over the window,
per query, in ms."""


def read(ctx):
    s = ctx["stage_times"].get("host_loop")
    return None if s is None or not ctx["queries"] else 1e3 * s / ctx["queries"]

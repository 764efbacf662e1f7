"""The program's `gates.dispatch` seconds (STAGE_TIMES: building and
launching the TM/LDDT gate fleets inside the host loop) over the window,
per query, in ms."""


def read(ctx):
    s = ctx["stage_times"].get("gates.dispatch")
    return 1e3 * s / ctx["queries"] if s and ctx["queries"] else None

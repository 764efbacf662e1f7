"""The program's `gates_drain` stage seconds (STAGE_TIMES: waiting for the
TM/LDDT gate fleets) over the window, per query, in ms."""


def read(ctx):
    s = ctx["stage_times"].get("gates_drain")
    return None if s is None or not ctx["queries"] else 1e3 * s / ctx["queries"]

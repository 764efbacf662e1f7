"""The program's `mode3.order` seconds (STAGE_TIMES: each query's E-value
gate and lexsort in `_mode3_records`) over the window, per query, in ms."""


def read(ctx):
    s = ctx["stage_times"].get("mode3.order")
    return 1e3 * s / ctx["queries"] if s and ctx["queries"] else None

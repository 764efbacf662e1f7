"""The program's `mode3.evalues` seconds (STAGE_TIMES: each query's
E-value network, distinct scores and scalar E-values in `_mode3_records`)
over the window, per query, in ms."""


def read(ctx):
    s = ctx["stage_times"].get("mode3.evalues")
    return 1e3 * s / ctx["queries"] if s and ctx["queries"] else None

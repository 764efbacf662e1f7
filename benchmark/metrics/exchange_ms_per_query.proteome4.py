"""Rank 0's wall seconds in the ranks' two exchanges a call (STAGE_TIMES:
`prefilter.exchange`, the all_gather of the candidates and the global
top-k; `align.exchange`, the gather of the records, their merge and each
query's final order) over the window, per query, in ms. None where the
program has no such span (a world of one, or a program that does not
exchange)."""


def read(ctx):
    t = ctx["stage_times"]
    parts = [t[k] for k in ("prefilter.exchange", "align.exchange") if k in t]
    return 1e3 * sum(parts) / ctx["queries"] if parts and ctx["queries"] \
        else None

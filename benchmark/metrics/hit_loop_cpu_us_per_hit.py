"""Thread CPU microseconds of `align_query`'s loop over the candidates
(`align.hits_cpu`, STAGE_TIMES) over the records it returned (the sum of
STAGE_COUNTS `align_hits`) in the window."""


def read(ctx):
    s = ctx["stage_times"].get("align.hits_cpu")
    n = sum(ctx["stage_counts"].get("align_hits", []))
    return 1e6 * s / n if s and n else None

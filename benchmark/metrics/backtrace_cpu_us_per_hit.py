"""Thread CPU microseconds of the align pool's batched tracebacks
(`align.backtraces_cpu`, STAGE_TIMES) over the pairs given a traceback
(the sum of STAGE_COUNTS `align_backtraces`) in the window."""


def read(ctx):
    s = ctx["stage_times"].get("align.backtraces_cpu")
    n = sum(ctx["stage_counts"].get("align_backtraces", []))
    return 1e6 * s / n if s and n else None

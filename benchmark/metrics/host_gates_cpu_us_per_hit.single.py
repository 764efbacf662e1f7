"""Thread CPU microseconds of the host's batched TM/LDDT gates
(`align.gates_cpu`, STAGE_TIMES) over the records `align_query` returned
(the sum of STAGE_COUNTS `align_hits`) in the window."""


def read(ctx):
    s = ctx["stage_times"].get("align.gates_cpu")
    n = sum(ctx["stage_counts"].get("align_hits", []))
    return 1e6 * s / n if s and n else None

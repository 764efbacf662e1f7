"""Per-call set-up over the window, per query, in ms: the program's
`align.setup` (the E-value network, the query and target key maps) plus
`format.setup` (the key maps and taxonomy of the m8 lines) seconds
(STAGE_TIMES, host wall). With one query a call, the set-up of each call."""


def read(ctx):
    t = ctx["stage_times"]
    if "align.setup" not in t or "format.setup" not in t \
            or not ctx["queries"]:
        return None
    s = t["align.setup"] + t["format.setup"]
    return 1e3 * s / ctx["queries"] if s else None

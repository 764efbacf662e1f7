"""The prefilter stage's host self time over the window, per query, in ms:
the program's `prefilter` seconds less its waits on the kernels
(`prefilter.launches`, `prefilter.readback`; STAGE_TIMES, host wall): the
profiles, their upload, the gate, the lexsort and the candidate lists."""


def read(ctx):
    t = ctx["stage_times"]
    if "prefilter" not in t or "prefilter.readback" not in t \
            or not ctx["queries"]:
        return None
    host = (t["prefilter"] - t["prefilter.readback"]
            - t.get("prefilter.launches", 0.0))
    return 1e3 * host / ctx["queries"] if host > 0 else None

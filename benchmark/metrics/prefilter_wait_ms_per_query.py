"""The prefilter's wait on its kernels over the window, per query, in ms:
the program's `prefilter.launches` (the K1 launch loop, where each launch
first brings its query stack's lengths home and so waits for the launch
before it) plus `prefilter.readback` (each split's copy home, which waits
for its last launches and top-k) seconds (STAGE_TIMES, host wall)."""


def read(ctx):
    t = ctx["stage_times"]
    if "prefilter.readback" not in t or not ctx["queries"]:
        return None
    wait = t["prefilter.readback"] + t.get("prefilter.launches", 0.0)
    return 1e3 * wait / ctx["queries"] if wait else None

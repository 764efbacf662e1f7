"""The mean number of cores the align pool keeps busy: its thread CPU
seconds (`align.query_cpu`, STAGE_TIMES) over the host loop's wall seconds
less the gate fleets' dispatch on the calling thread (`host_loop` less
`gates.dispatch`, 0 when absent)."""


def read(ctx):
    t = ctx["stage_times"]
    cpu, loop = t.get("align.query_cpu"), t.get("host_loop")
    if not cpu or not loop:
        return None
    wall = loop - t.get("gates.dispatch", 0.0)
    return cpu / wall if wall > 0 else None

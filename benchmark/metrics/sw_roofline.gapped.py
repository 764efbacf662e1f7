"""Share of the 3Di-only Smith-Waterman kernel's bound (mode 3: every traced
query against every DB target, 5.5 integer instructions a cell, or the bytes)
that the traced calls' summed kernel time reaches, in %."""
from benchmark import roofline as R


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["intervals"]:
        return None
    q = tr["query_lengths"]
    cells = R.cells_all_targets(q, ctx["db_residues"])
    nbytes = R.sw_all_bytes(q, ctx["db_residues"], ctx["db_entries"])
    bound, kind = R.bound_seconds(cells, R.SW_NO_AA_OPS_PER_CELL, nbytes)
    dev = R.kernel_seconds(tr["intervals"])
    ctx["log"](f"sw roofline: {cells} cells, bound {bound!r} s by {kind}, "
               f"kernels {dev!r} s")
    return R.roofline_percent(bound, dev)

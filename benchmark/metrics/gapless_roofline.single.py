"""Share of the ungapped prefilter kernel's bound that the traced calls'
device time reaches, in %: the bound of one scan of every DB target for each
traced query (0.75 integer instructions a cell, or the bytes), over the
summed time of every kernel of those calls."""
from benchmark import roofline as R


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["intervals"]:
        return None
    q = tr["query_lengths"]
    cells = R.cells_all_targets(q, ctx["db_residues"])
    nbytes = R.gapless_bytes(q, ctx["db_residues"], ctx["db_entries"])
    bound, kind = R.bound_seconds(cells, R.GAPLESS_OPS_PER_CELL, nbytes)
    dev = R.kernel_seconds(tr["intervals"])
    ctx["log"](f"gapless roofline: {cells} cells, bound {bound!r} s by "
               f"{kind}, kernels {dev!r} s")
    return R.roofline_percent(bound, dev)

"""How unevenly the cards share the sharded align stage: the busiest
rank's pairs in each call (STAGE_COUNTS `shard.pairs_max`, summed over the
window) times the world's size over all ranks' pairs (`shard.pairs_all`,
summed). 1.0 when every card aligns as many pairs, the world's size when
one card aligns them all; the slowest card paces every call. None where
the program records no such counts."""


def read(ctx):
    most = sum(ctx["stage_counts"].get("shard.pairs_max", []))
    every = sum(ctx["stage_counts"].get("shard.pairs_all", []))
    return most * len(ctx["ranks"]) / every if every else None

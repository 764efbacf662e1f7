"""Median query latency of the window (host clock)."""
import statistics


def read(ctx):
    return statistics.median(ctx["latencies"]) if ctx["latencies"] else None

"""95th percentile of every query's latency in the window, from its call's
start to its m8 lines in hand (host clock; statistics.quantiles, n=20)."""
import statistics


def read(ctx):
    lat = ctx["latencies"]
    return statistics.quantiles(lat, n=20)[-1] if len(lat) >= 20 else None

"""Small sizes of the cells for CPU runs of the harness."""
import copy

from benchmark import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")


def tiny(workload, entries=300, pool=8, check_all=True, length_mean=90):
    _cell, cfg, traffic = harness.load_cell(BENCH, workload)
    cfg = copy.deepcopy(cfg)
    traffic = dict(traffic)
    cfg["db"].update(entries=entries, length_mean=length_mean,
                     length_max=3 * length_mean, family_size_max=40)
    qpc = min(4, traffic["queries_per_call"])
    traffic.update(pool=pool if qpc > 1 else 4, queries_per_call=qpc,
                   trace_calls=1)
    if check_all:
        traffic.update(check_queries=traffic["pool"])
    return cfg, traffic

"""The control of a cell's check: the reference put in the program's place,
with its Smith-Waterman scores computed in 8-bit saturating arithmetic
(every H clamped at 255, the byte pass of a striped SW without its 16-bit
rescue), judged by the same comparison against the full-precision
reference. The check must call it wrong.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

runs at the cell's own size (the DB of each seed, the queries a run of
that seed would sample from its first calls) and prints one JSON line per
seed with the numbers, their limits and the verdict. The program does not
run; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SAT = 255


def control_numbers(bench, workload: str, seed: int, device, sat: int = SAT,
                    cfg=None, traffic=None, log=None):
    """(numbers, correct) of the control of one seed."""
    import torch
    from benchmark import harness
    from benchmark.checks.common import verdict
    from benchmark.gen import families as gen
    from benchmark.reference import dp
    import importlib
    _cell, cfg0, traffic0 = harness.load_cell(bench, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    dev = torch.device(device)
    t = time.perf_counter()
    g = gen.make_db(cfg["db"], seed)
    queries = gen.make_queries(
        g, cfg["db"], traffic["pool"], seed,
        fixed_params=bool(traffic.get("fixed_query_params", False)))
    order = gen.pool_order(g, queries, cfg["db"],
                           traffic.get("spread_heavy", 0))
    db = g.db
    check = importlib.import_module(f"benchmark.checks.{cfg['check']}")
    # the queries a run of four calls would sample
    qpc = traffic["queries_per_call"]
    calls = [order[c * qpc:(c + 1) * qpc]
             for c in range(min(4, traffic["pool"] // qpc))]
    pick = harness.pick_sample(calls, traffic, seed, queries.lengths)
    tables = dp.TargetTables(db.ss, db.offsets, dev)
    lens = np.diff(db.offsets)
    sample = []
    for i in pick:
        o0, o1 = queries.offsets[i], queries.offsets[i + 1]
        q = dict(name=f"Q{i}", key=i, aa=queries.aa[o0:o1],
                 ss=queries.ss[o0:o1], ca=queries.ca[o0:o1], lines=None)
        q["expected"] = check.expected(q, db, tables, cfg["search"], dev)
        low = check.expected(q, db, tables, cfg["search"], dev, sat=sat)
        if isinstance(low, dict):        # mode 1: target -> facts
            recs = [dict(key=k, score=v["raw"], q_start=None,
                         q_end=v["q_end"], t_start=None, t_end=v["t_end"],
                         evalue=v["evalue"], backtrace=None)
                    for k, v in low.items()]
            recs.sort(key=lambda r: (-r["score"], lens[r["key"]], r["key"]))
        else:                            # mode 3: the ordered list
            recs = [dict(e, q_start=0, t_start=0, backtrace=None)
                    for e in low]
        q["records"] = recs
        sample.append(q)
    numbers = check.compare(sample, db, cfg["limits"], seed)
    correct, lines = verdict(numbers, cfg["limits"])
    if log:
        log(f"control seed {seed}: {time.perf_counter() - t:.1f} s, "
            f"queries {pick}")
        for line in lines:
            log(line)
    return numbers, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness
    import torch
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        numbers, correct = control_numbers(bench, args.workload, seed,
                                           "cuda:0", log=harness.log)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              sat=SAT, correct=correct,
                              numbers=numbers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

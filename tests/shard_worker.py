"""One rank of the row-sharded search worlds of test_torch_shard.py, and
the calls each rank makes (`run`, which the test also makes in its own
process as the world of one).

    python tests/shard_worker.py OUT --entries N --init-method file://STORE \\
        --world-size W --rank R

Every rank forms a gloo world with `init_distributed` (on the CPU, or with
`--device cuda:0` every rank on one card), generates
the same DB of adjacent families and the same queries from the seed with
the benchmark's generator at the `afdb50_gpu` configuration's small sizes,
and makes two calls of `search` and `format_results` of four queries each
through the benchmark's driver. It writes OUT.<rank>.json: per call the m8
lines, every record with its floats as hex, the stage keys and counts the
call left, and the resident panel sets with what each holds.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 2**31 + 57
QUERIES_PER_CALL = 4
FLOATS = ("seq_id", "evalue", "qcov", "tcov", "lddt", "tm")
INTS = ("db_key", "score", "q_start", "q_end", "q_len", "t_start", "t_end",
        "t_len", "aln_length", "identical")


def record(r) -> list:
    """Every field of a record; floats to the bit."""
    return ([int(getattr(r, f)) for f in INTS]
            + [float(getattr(r, f)).hex() for f in FLOATS] + [r.backtrace])


def run(entries: int, calls: int = 2, seed: int = SEED,
        device: str = "cpu", max_accept: int = 0) -> list:
    import numpy as np
    import torch

    from benchmark.drivers.search import SearchDriver
    from benchmark.gen import families as gen
    from benchmark.tests._tiny import tiny
    from foldseek_tpu_torch.db import panels
    from foldseek_tpu_torch.utils.log import (reset_stage_times,
                                              snapshot_stage_counts,
                                              snapshot_stage_times)
    cfg, _traffic = tiny("afdb50_gpu.proteome4", entries=entries)
    if max_accept:
        cfg["search"]["max_accept"] = max_accept
    g = gen.make_db(cfg["db"], seed, threads=1)
    queries = gen.make_queries(g, cfg["db"], QUERIES_PER_CALL * calls, seed)
    driver = SearchDriver(cfg, g.db, torch.device(device))
    out = []
    for c in range(calls):
        reset_stage_times()
        qdb = driver.batch(queries, np.arange(QUERIES_PER_CALL * c,
                                              QUERIES_PER_CALL * (c + 1)))
        res, lines = driver.call(qdb)
        out.append(dict(
            lines=lines,
            records={str(qk): [record(r) for r in rs]
                     for qk, rs in sorted(res.items())},
            times=sorted(snapshot_stage_times()),
            counts=snapshot_stage_counts(),
            resident=[dict(entries=p.n_entries, residues=len(p.db.aa),
                           first_key=int(p.db.keys[0]) if p.n_entries
                           else -1)
                      for p in panels._resident_sets.values()]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--entries", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--max-accept", type=int, default=0,
                    help="an accept budget (0: the configuration's)")
    ap.add_argument("--device", default="cpu",
                    help="cpu, or one card that every rank shares (gloo)")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from foldseek_tpu_torch.parallel.distributed import init_distributed
    init_distributed(args.init_method, args.world_size, args.rank,
                     device=args.device, backend="gloo",
                     timeout_seconds=120)
    try:
        out = run(args.entries, device=args.device,
                  max_accept=args.max_accept)
    finally:
        dist.destroy_process_group()
    with open(f"{args.out}.{args.rank}.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()

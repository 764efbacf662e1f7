#!/usr/bin/env python3
"""The port's distribution across cards: N ranks of the worker, one a card,
under torchrun, against the single process on the first device.

    python3 tools/torch_distributed_cards.py [--cards 4] [--targets 100000]
        [--queries 16] [--cluster-entries 1000] [--device cuda]
        [--out-dir DIR]

Builds chip_smoke.py's DBs (synthetic targets and queries grown from the
repo's fixture structures, a workflow DB of --cluster-entries), runs on the
first device the single-process prefilter, mode-1 search (backtraces, host
gates) and cluster_db, then `python -m torch.distributed.run --standalone
--nproc-per-node N -m foldseek_tpu_torch.parallel.worker` over the same DBs
(NCCL on cuda:LOCAL_RANK; gloo with --device cpu, for a check without
cards). Every rank's prefilter lists, long query, m8 and clusters must equal
the single process's. Prints one JSON line with the single process's
seconds and each rank's path seconds, launches and busy time; exits nonzero
on a mismatch or a failed rank.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--targets", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--cluster-entries", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=os.path.join(
        REPO, "foldseek_tpu_torch", "build", "distributed"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from foldseek_tpu_torch.cluster.workflow import ClusterParams, cluster_db
    from foldseek_tpu_torch.db import synth_db
    from foldseek_tpu_torch.device import get_device
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search.ungapped import UngappedPrefilter

    dev = get_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.cards:
        raise SystemExit(f"{args.cards} cards asked for, "
                         f"{torch.cuda.device_count()} present")
    os.makedirs(args.out_dir, exist_ok=True)
    rec = dict(cards=args.cards, device=str(dev))
    if dev.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    with tempfile.TemporaryDirectory(dir=args.out_dir) as work:
        base, tdb, qdb, _ = cs.build_dbs(work, args.targets, args.queries, 1)
        cdb = synth_db(base, args.cluster_entries,
                       os.path.join(work, "workflow"), seed=1)
        seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
        t0 = time.perf_counter()
        with cs.gates_env("0"):
            single = UngappedPrefilter(tdb, dev)
            params = SearchParams()
            want = {"prefilter_0": [[list(h) for h in q] for q in
                                    single.query_batch(seqs, params)],
                    "long": [list(h) for h in single.query(
                        np.concatenate(seqs), params)]}
            del single
            res, _ = cs.run_search(qdb, tdb, dev, 1)
            want["search"] = cs.m8_bytes(qdb, tdb, res).decode()
            want["cluster"] = [[int(k), [int(m) for m in v]] for k, v in
                               sorted(cluster_db(cdb, ClusterParams(),
                                                 dev).items())]
        rec["single_seconds"] = time.perf_counter() - t0
        out = os.path.join(work, "ranks")
        env = dict(os.environ, OMP_NUM_THREADS="2", FOLDSEEK_TPU_FORK="0",
                   FOLDSEEK_TPU_DEVICE_GATES="0", PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(args.cards), "-m",
             "foldseek_tpu_torch.parallel.worker", out, "--queries",
             qdb.path, "--targets", tdb.path, "--cluster-db", cdb.path,
             "--device", args.device], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=900)
        rec["world_seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"torchrun exited {proc.returncode}")
        bad, rec["ranks"] = [], []
        for r in range(args.cards):
            with open(f"{out}.{r}.json") as f:
                got = json.load(f)
            paths = {}
            for name, p in got["paths"].items():
                same = p["result"] == want[name]
                bad += [] if same else [f"rank {r} {name}"]
                paths[name] = dict(seconds=p["seconds"],
                                   launches=p["launches"],
                                   device_busy_ms=p.get("device_busy_ms"),
                                   identical=same)
            rec["ranks"].append(dict(rank=got["rank"], size=got["size"],
                                     device=got["device"], paths=paths))
    print(json.dumps(rec))
    if bad:
        print(f"distributed results differ from the single process: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

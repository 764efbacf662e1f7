"""One rank of a multi-rank run of the distributed paths.

    torchrun --nproc-per-node 2 -m foldseek_tpu_torch.parallel.worker OUT \\
        --queries QDB --targets TDB [--cluster-db DB] [--multimer QDB TDB]

Without torchrun, give each rank the rendezvous yourself: `--init-method
file:///path/to/store --world-size N --rank R`. Every rank forms the world
with `init_distributed` (its device `--device`, default `cuda:LOCAL_RANK`;
`--backend gloo` lets ranks share one card), then runs the paths its
arguments name, each with the launch counts and stage times set to 0 just
before it:
  prefilter  DistributedPrefilter.query_batch of the queries against every
             `--targets` DB, and sharded_gapless_long of the queries' 3Di
             joined into one query against the first;
  search     distributed_search of the queries against the first `--targets`
             DB (prefilter mode 1, backtraces), printed as m8;
  cluster    cluster_db of `--cluster-db` with the defaults (each cluster's
             members in their order, representative first);
  multimer   multimer_search of the `--multimer` DBs (prefilter mode 1 with
             `--multimer-gpu`, as `multimersearch --gpu 1`).
On a card each path also records the milliseconds the card spent in its
kernels and copies (torch.profiler, CUDA activity).
Each rank writes its results, launches and stage seconds to OUT.<rank>.json
and exits nonzero when a path fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _counted(fn, device):
    """fn() with the launch counts and stage times set to 0 just before:
    {result, seconds, launches, stages}; on a card also the milliseconds it
    spent in kernels and copies under torch.profiler's CUDA activity
    (`device_busy_ms`, None when the profiler saw none)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils.log import (reset_stage_times, snapshot_stage_times,
                             stage_count)
    reset_stage_times()
    on_card = device.type == "cuda"
    with (profile(activities=[ProfilerActivity.CUDA]) if on_card
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        result = fn()
        if on_card:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    out = dict(result=result, seconds=seconds,
               launches={k: stage_count("launches." + k)
                         for k in ("gapless", "gapless_dual", "sw")},
               stages=snapshot_stage_times())
    if on_card:
        cuda = torch.autograd.DeviceType.CUDA
        # the program's "fs." ranges are mirrored onto the device's track:
        # no device work
        ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda
                 and not e.name().startswith("fs."))
        out["device_busy_ms"] = ns / 1e6 or None
    return out


def run(args) -> dict:
    from ..db.storage import load_db
    from ..search.convertalis import format_results
    from ..search.params import SearchParams
    from ..search.ungapped import MIN_DIAG_SCORE, make_query_profile
    from .distributed import (DistributedPrefilter, distributed_search,
                              init_distributed, rank_device, world)
    from .mesh import sharded_gapless_long

    init_distributed(args.init_method, args.world_size, args.rank,
                     device=args.device, backend=args.backend,
                     timeout_seconds=args.timeout)
    rank, size = world()
    device = rank_device()
    out = dict(rank=rank, size=size, device=str(device), paths={})
    params = SearchParams(max_seqs=args.max_seqs)
    paths = out["paths"]
    if args.queries and args.targets:
        qdb = load_db(args.queries)
        seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
        prefs = []
        for i, path in enumerate(args.targets):
            def prefilter(path=path):
                prefs.append(DistributedPrefilter(load_db(path), device))
                return prefs[-1].query_batch(seqs, params)
            paths[f"prefilter_{i}"] = _counted(prefilter, device)

        def long_query():
            prof, bias = make_query_profile(np.concatenate(seqs))
            s, k = sharded_gapless_long(prefs[0].st, prof, bias,
                                        params.max_seqs)
            ok = (s > MIN_DIAG_SCORE) & (k >= 0)
            return [(int(a), int(b)) for a, b in zip(k[ok], s[ok])]
        paths["long"] = _counted(long_query, device)
        del prefs
        if not args.skip_search:
            tdb = load_db(args.targets[0])
            sparams = SearchParams(prefilter_mode=1, add_backtrace=True,
                                   max_seqs=args.max_seqs)

            def search():
                res = distributed_search(qdb, tdb, sparams, device)
                lines = format_results(qdb, tdb, res, sparams.format_output,
                                       with_backtrace=True)
                return "".join(line + "\n" for line in lines)
            paths["search"] = _counted(search, device)
    if args.cluster_db:
        from ..cluster.workflow import ClusterParams, cluster_db
        db = load_db(args.cluster_db)
        paths["cluster"] = _counted(lambda: [
            (int(k), [int(m) for m in v]) for k, v in sorted(
                cluster_db(db, ClusterParams(), device).items())], device)
    if args.multimer:
        from ..multimer.workflow import multimer_search
        mq, mt = (load_db(p) for p in args.multimer)
        mparams = SearchParams(prefilter_mode=1 if args.multimer_gpu else 0)
        paths["multimer"] = _counted(lambda: [
            f"{qk}\t{line}" for qk, lines in sorted(
                multimer_search(mq, mt, mparams, device).items())
            for line in lines], device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m foldseek_tpu_torch.parallel.worker",
        description="one rank of a multi-rank run of the distributed paths")
    ap.add_argument("out", help="each rank writes OUT.<rank>.json")
    ap.add_argument("--queries", default="")
    ap.add_argument("--targets", nargs="*", default=[])
    ap.add_argument("--skip-search", action="store_true",
                    help="only the prefilter paths over --targets")
    ap.add_argument("--cluster-db", default="")
    ap.add_argument("--multimer", nargs=2, default=None,
                    metavar=("QUERY_DB", "TARGET_DB"))
    ap.add_argument("--multimer-gpu", action="store_true",
                    help="the multimer chain search's prefilter as --gpu 1")
    ap.add_argument("--max-seqs", type=int, default=1000)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (default: torchrun's env://)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on a card) or gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a collective may wait for its peers")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    try:
        out = run(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{args.out}.{out['rank']}.json", "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

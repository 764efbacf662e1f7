#!/usr/bin/env python3
"""Seconds of the cpu side of chip_smoke.py's workflow parity at a DB size.

    python3 tools/torch_workflow_parity_seconds.py [--entries 2000]
        [--workflows easy_cluster,clusearch,rbh,multimer]
        [--multimercluster-entries 120,240]
        [--groups taxonomy,msa_profile+swapresults,...]

Builds the DBs as chip_smoke.py does (the fixture base expanded by
`synth_db`: 16 queries, `--entries` parity targets, both regrouped into
two-chain complexes for the multimer search) and runs each workflow of the
port on the CPU with the host's gates, printing one line a workflow:
"<name> <entries> entries: <seconds> s". `--groups` runs groups of
chip_smoke.py's own phase-7 comparisons (names joined by "+" share one
group, as in PARITY_GROUPS) through its `parity_side` on the cpu, over the
inputs of its `parity_inputs` with `--entries` parity targets, one torch
thread as in a worker of an 8-core host's two. It needs no GPU; it tells
what a parity size costs the smoke run before the card is asked.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entries", type=int, default=2000)
    ap.add_argument("--workflows",
                    default="easy_cluster,clusearch,rbh,multimer")
    ap.add_argument("--multimercluster-entries", default="120")
    ap.add_argument("--groups", default="",
                    help="chip_smoke.py phase-7 groups, e.g. "
                         "taxonomy,msa_profile+swapresults")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from foldseek_tpu_torch.db import synth_db
    from foldseek_tpu_torch.multimer.cluster import easy_multimer_cluster
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search.clusearch import create_clusearch_db
    from foldseek_tpu_torch.search.rbh import easy_rbh

    which = set(args.workflows.split(",")) - {""}
    cpu = torch.device("cpu")
    os.environ["FOLDSEEK_TPU_DEVICE_GATES"] = "0"
    with tempfile.TemporaryDirectory() as work:
        base, _tdb, qdb, pdb = cs.build_dbs(work, 1, 16, args.entries)

        def timed(name, n, fn):
            t0 = time.perf_counter()
            out = fn()
            print(f"{name} {n} entries: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out

        if which & {"easy_cluster", "clusearch"}:
            clusters = timed("easy_cluster", pdb.size, lambda: cs.cluster_files(
                pdb, cpu, os.path.join(work, "clu"),
                os.path.join(work, "clu_tmp")))
        if "clusearch" in which:
            path = os.path.join(work, "clusearch")
            create_clusearch_db(pdb, clusters, path)
            timed("clusearch", pdb.size, lambda: cs.clusearch_lines(
                qdb, path, cpu, os.path.join(work, "clusearch_tmp")))
        if "rbh" in which:
            timed("rbh", pdb.size, lambda: easy_rbh(
                qdb.path, pdb.path, os.path.join(work, "rbh.m8"),
                os.path.join(work, "rbh_tmp"), SearchParams(prefilter_mode=1),
                cpu))
        if "multimer" in which:
            pm = cs.complex_db(pdb, os.path.join(work, "complex_targets"))
            qm = cs.complex_db(qdb, os.path.join(work, "complex_queries"))
            timed("multimer", pdb.size, lambda: cs.multimer_report(qm, pm, cpu))
        for n in (int(x) for x in args.multimercluster_entries.split(",") if x):
            mm = cs.complex_db(
                synth_db(base, n, os.path.join(work, f"mmclu_src{n}"), seed=3),
                os.path.join(work, f"mmclu{n}"))
            timed("multimercluster", n, lambda: easy_multimer_cluster(
                mm.path, os.path.join(work, f"mmclu{n}"),
                os.path.join(work, f"mmclu_tmp{n}"), SearchParams(), cpu))
        groups = [tuple(g.split("+")) for g in args.groups.split(",") if g]
        if groups:
            paths = cs.parity_inputs(base, pdb, qdb, work)
            torch.set_num_threads(1)
            os.environ["FOLDSEEK_TPU_FORK"] = "0"
            for group in groups:
                out, _ = cs.parity_side(group, paths, "cpu")
                for name, (_outputs, seconds) in out.items():
                    print(f"{name} {pdb.size} entries: {seconds:.1f} s",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

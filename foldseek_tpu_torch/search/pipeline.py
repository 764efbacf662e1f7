"""Search workflows of the port: easy-search / search as an in-process stage
graph (reference: data/structuresearch.sh, data/easystructuresearch.sh,
src/workflow/StructureSearch.cpp).

Port of `foldseek_tpu/search/pipeline.py`: with a tmp dir, the prefilter
and align stages persist their artifacts through `search/stages.py` and a
re-invoked run resumes from them. Every entry point takes the torch device
the stages run on. In a `torch.distributed` world of more than one rank
(`parallel/distributed.py`) every align stage is sharded by query with an
all_gather merge and the stage cache is off.
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..db import StructDB, create_db, is_db, load_db
from ..utils.log import Timer, logger
from .align import align_all
from .convertalis import format_results, needs_backtrace, write_output
from .params import (PREF_MODE_UNGAPPED, PREF_MODE_UNGAPPED_AND_GAPPED,
                     SearchParams)
from .prefilter import run_prefilter
from .results import AlnResult
from .stages import make_cache


def ensure_db(path_or_input: str, tmp_dir: str, tag: str) -> StructDB:
    """Accept either an existing StructDB directory or raw structure
    files/dirs (easy-* convenience, data/easystructuresearch.sh:18-27)."""
    if is_db(path_or_input):
        return load_db(path_or_input)
    db_path = os.path.join(tmp_dir, f"{tag}_db")
    if is_db(db_path):
        logger.info("reusing %s", db_path)
        return load_db(db_path)
    return create_db([path_or_input], db_path)


def search(qdb: StructDB, tdb: StructDB, params: SearchParams,
           device: torch.device, same_db: Optional[bool] = None,
           tmp_dir: Optional[str] = None) -> Dict[int, List[AlnResult]]:
    from ..parallel.distributed import world
    if same_db is None:
        same_db = qdb.path == tdb.path
    # stage-resume is single-process-only: concurrent ranks would race on
    # one artifact dir (the reference uses rank-local tmp + a master move,
    # Prefiltering.cpp:589-660)
    cache = make_cache(tmp_dir, params, qdb, tdb) if world()[1] == 1 else None
    if params.cluster_search:
        # search representatives, expand hits to cluster members, re-align
        # against the full _seq DB (data/structuresearch.sh:125-140)
        from .clusearch import expand_hits, load_clusearch
        loaded = load_clusearch(tdb.path)
        if loaded is None:
            raise ValueError(
                f"--cluster-search requires {tdb.path}_seq and "
                f"{tdb.path}_clu.tsv (run createclusearchdb)")
        rep_db, seq_db, clu_map = loaded
        with Timer("cluster-search rep search"):
            first = search(qdb, rep_db, replace(params, cluster_search=0),
                           device, same_db=False, tmp_dir=tmp_dir)
        with Timer("expand(cluster-search)"):
            expanded = expand_hits(first, clu_map)
        with Timer("cluster-search member align"):
            return _align_stage(qdb, seq_db, expanded, params, device,
                                same_db=False, cache=cache)
    if params.prefilter_mode == PREF_MODE_UNGAPPED_AND_GAPPED:
        # alignment-format results straight from the prefilter pass
        # (ungappedprefilter.cpp:274-291): no align stage
        from .ungapped import ungapped_and_gapped_results

        def run():
            with Timer("ungapped+gapped prefilter"):
                return ungapped_and_gapped_results(qdb, tdb, params, same_db,
                                                   device)
        return cache.run_aln("prefaln", run) if cache is not None else run()

    def run_pref():
        with Timer("prefilter"):
            return run_prefilter(qdb, tdb, params, device)
    pref = cache.run_pref("pref", run_pref) if cache is not None else run_pref()
    return _align_stage(qdb, tdb, pref, params, device, same_db=same_db,
                        cache=cache)


def _align_stage(qdb: StructDB, tdb: StructDB, pref: Dict[int, List[int]],
                 params: SearchParams, device: torch.device, same_db: bool,
                 cache=None) -> Dict[int, List[AlnResult]]:
    # in a world of several ranks every align stage is query-sharded with
    # an all_gather merge (the $RUNNER prefix the reference puts on each
    # heavy stage, data/structuresearch.sh:46-53); a world of one rank runs
    # the plain in-process stage
    from ..parallel.distributed import sharded_align_all, world
    sharded = world()[1] > 1

    def stage(stage_fn):
        if sharded:
            return sharded_align_all(qdb, tdb, pref, params, device,
                                     same_db=same_db, stage_fn=stage_fn)
        return stage_fn(qdb, tdb, pref, params, same_db=same_db)

    def run():
        if params.alignment_type == 1:  # TM-align (StructureSearch.cpp:128-135)
            from .tmalign_stage import tmalign_all
            with Timer("tmalign"):
                return stage(tmalign_all)
        if params.alignment_type == 3:  # LoLalign
            from .lolalign_stage import lolalign_all
            with Timer("lolalign"):
                return stage(lolalign_all)
        with Timer("structurealign"):
            if sharded:
                return sharded_align_all(qdb, tdb, pref, params, device,
                                         same_db=same_db)
            return align_all(qdb, tdb, pref, params, device, same_db=same_db)
    if cache is not None:
        # backtraces are always persisted: a resumed run must reproduce the
        # in-memory records (result2profile in iterative search consumes
        # them)
        return cache.run_aln("aln", run)
    return run()


def profile_search(profiles, tdb: StructDB, params: SearchParams,
                   device: torch.device) -> Dict[int, List[AlnResult]]:
    """Profile-vs-sequence search: the query side is a profile DB
    (result2profile output) instead of a structure DB, the reference's
    profile search mode (lib/mmseqs/src/alignment/Alignment.cpp profile
    path; the prefilter feeds the PSSM like the GPU path,
    ungappedprefilter.cpp:135-199). TM/LDDT gates are off (profiles carry
    no C-alpha payload)."""
    from .profile import ProfileQueryDB, profile_query
    from .ungapped import resident_prefilter

    qprofiles = {k: profile_query(p, params.gap_open, params.gap_extend)
                 for k, p in profiles.items()}
    upref = resident_prefilter(tdb, device)
    with Timer("profile prefilter"):
        hits = upref.query_profiles(
            [qp.prof_ss for qp in qprofiles.values()], params)
        pref = {qkey: [t for t, _ in h] for qkey, h in zip(qprofiles, hits)}
    qdb = ProfileQueryDB(profiles)
    params = replace(params, sort_by_structure_bits=False)
    with Timer("structurealign(profile)"):
        return align_all(qdb, tdb, pref, params, device, same_db=False,
                         query_profiles=qprofiles)


def iterative_search(qdb: StructDB, tdb: StructDB, params: SearchParams,
                     num_iterations: int, device: torch.device,
                     same_db: Optional[bool] = None,
                     tmp_dir: Optional[str] = None
                     ) -> Dict[int, List[AlnResult]]:
    """Profile-boosted iterative search (the reference's --num-iterations
    path, StructureSearch.cpp:158-208 + data/structureiterativesearch.sh):
    plain search, then per iteration (1) prefilter with AA+3Di PSSMs built
    from the merged alignments so far, (2) subtractdbs: drop candidates
    already aligned in earlier rounds, (3) align only the new candidates
    with the profile queries, (4) mergedbs: keep every earlier round's
    records verbatim and append the new ones. In prefilter mode 1 the
    per-iteration prefilter is the gapless device scan fed with the 3Di
    PSSM; otherwise the k-mer PSSM prefilter. Each iteration's alignment DB
    is a resumable stage artifact (`aln_iter{n}`) when a tmp dir is given."""
    from .profile import profile_query, pssm_store_bytes, result2profile
    if same_db is None:
        same_db = qdb.path == tdb.path
    cache = make_cache(tmp_dir, params, qdb, tdb)
    # non-final iterations run with the strict profile e-value gate and
    # backtraces on (StructureSearch.cpp:158-180: evalThr = min(e,
    # e-profile), 0.001 when --e-profile is unset; addBacktrace = true);
    # the final iteration restores the caller's -e
    if params.e_profile >= 0.0:
        e_nonfinal = min(params.evalue_thr, params.e_profile)
    else:
        e_nonfinal = 0.001
    p_nonfinal = replace(params, evalue_thr=e_nonfinal, add_backtrace=True)
    p_final = replace(params, add_backtrace=True)
    results = search(qdb, tdb, p_nonfinal, device, same_db=same_db,
                     tmp_dir=tmp_dir)
    upref = None
    for it in range(1, num_iterations):
        def run_iter(results=results, it=it):
            nonlocal upref
            with Timer(f"result2profile(iter {it})"):
                profiles = result2profile(qdb, tdb, results)
                qprofiles = {k: profile_query(p, params.gap_open,
                                              params.gap_extend)
                             for k, p in profiles.items()}
            with Timer(f"profile prefilter(iter {it})"):
                if params.prefilter_mode == PREF_MODE_UNGAPPED:
                    from .ungapped import resident_prefilter
                    if upref is None:
                        upref = resident_prefilter(tdb, device)
                    # all profile queries as one stack: one launch a bucket
                    hits = upref.query_profiles(
                        [qp.prof_ss for qp in qprofiles.values()], params)
                    pref = {qkey: [k for k, _ in h]
                            for qkey, h in zip(qprofiles, hits)}
                else:
                    from ..ops.matrices import mat3di
                    from .kmer import KmerPrefilter
                    if upref is None:
                        upref = KmerPrefilter(tdb, params, bias_scale=0.15,
                                              profile_mode=True)
                    m3 = mat3di()
                    qk_to_idx = qdb.key_to_index()
                    tkeys = np.asarray(tdb.keys, dtype=np.int64)
                    pref = {}
                    for qkey, p in profiles.items():
                        # SS stored bytes carry no composition-bias
                        # correction (result2structprofile.cpp:40)
                        pssm = pssm_store_bytes(p.prob_ss, m3.p_back,
                                                comp_bias_correction=False)
                        letters = np.asarray(
                            qdb.get_ss(qk_to_idx[int(qkey)]), dtype=np.int64)
                        hits = upref.query_pssm(pssm, letters,
                                                params.max_seqs)
                        pref[qkey] = [int(tkeys[t]) for t, _s, _d in hits]
            # subtractdbs: only candidates not aligned in earlier rounds go
            # to the profile alignment (structureiterativesearch.sh:46-49)
            aligned = {int(qkey): {int(r.db_key) for r in rs}
                       for qkey, rs in results.items()}
            n_pref = sum(len(v) for v in pref.values())
            pref = {qkey: [k for k in cands
                           if int(k) not in aligned.get(int(qkey), set())]
                    for qkey, cands in pref.items()}
            logger.debug("iter %d: %d prefilter candidates, %d new after "
                         "subtract", it, n_pref,
                         sum(len(v) for v in pref.values()))
            p_iter = p_final if it == num_iterations - 1 else p_nonfinal
            with Timer(f"structurealign(iter {it})"):
                new = align_all(qdb, tdb, pref, p_iter, device,
                                same_db=same_db, query_profiles=qprofiles)
            # mergedbs: earlier rounds' records stay verbatim, new hits
            # append (structureiterativesearch.sh:77-101)
            merged = {}
            for qkey in set(results) | set(new):
                merged[qkey] = list(results.get(qkey, [])) + \
                    list(new.get(qkey, []))
            return merged
        if cache is not None:
            results = cache.run_aln(f"aln_iter{it}", run_iter)
        else:
            results = run_iter()
    return results


def easy_search(query_input: str, target_input: str, out_path: str,
                tmp_dir: str, params: SearchParams,
                device: torch.device) -> List[str]:
    os.makedirs(tmp_dir, exist_ok=True)
    qdb = ensure_db(query_input, tmp_dir, "query")
    same_input = os.path.abspath(query_input) == os.path.abspath(target_input)
    tdb = qdb if same_input else ensure_db(target_input, tmp_dir, "target")
    params.add_backtrace = (params.add_backtrace
                            or needs_backtrace(params.format_output)
                            or params.format_mode in (1, 2, 3, 5)
                            # the iterative workflow always aligns with -a
                            # (StructureSearch.cpp:178) and its output
                            # columns derive from the stored backtraces
                            or params.num_iterations > 1)
    if params.num_iterations > 1:
        results = iterative_search(qdb, tdb, params, params.num_iterations,
                                   device, same_db=same_input,
                                   tmp_dir=tmp_dir)
    else:
        results = search(qdb, tdb, params, device, same_db=same_input,
                         tmp_dir=tmp_dir)
    if params.format_mode != 0:
        write_output(qdb, tdb, results, out_path, params.format_output,
                     params.format_mode, with_backtrace=params.add_backtrace)
        n = sum(len(v) for v in results.values())
        logger.info("easy-search: %d hits -> %s (format mode %d)",
                    n, out_path, params.format_mode)
        return []
    lines = format_results(qdb, tdb, results, params.format_output,
                           with_backtrace=params.add_backtrace)
    with open(out_path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    logger.info("easy-search: %d hits -> %s", len(lines), out_path)
    return lines

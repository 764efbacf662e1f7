"""multimersearch / easy-multimersearch workflows
(reference: src/workflow/MultimerSearch.cpp, data/multimersearch.sh,
data/easymultimersearch.sh).

Stages: chain-level search (default params, no backtrace) -> expandmultimer
(all chain pairs of hit complexes) -> structurealign with the relaxed
expansion e-value (1e4) and backtraces -> scoremultimer -> report/m8.

Copy of `foldseek_tpu/multimer/workflow.py`: the chain search and the
expand re-align run on the torch device the caller names. In a
`torch.distributed` world of more than one rank both are query-sharded with
an all_gather merge (`parallel/distributed.py`) and the stage cache is off.
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List

import torch

from ..db.storage import StructDB
from ..search.align import align_all
from ..search.params import SearchParams
from ..search.pipeline import ensure_db, search
from ..utils.log import Timer, logger
from .expand import expand_multimer
from .report import create_multimer_report
from .scoremultimer import score_multimer

EVALUE_THR_EXPAND_MULTIMER = 10000.0  # LocalParameters.cpp:355


def multimer_search(qdb: StructDB, tdb: StructDB,
                    params: SearchParams, device: torch.device,
                    filter_params=None,
                    tmp_dir: str = "") -> Dict[int, List[str]]:
    """Full multimer pipeline; returns scorecomplex result lines per query
    chain key. With a tmp_dir the chain search and the expanded re-align
    resume from stage artifacts (data/multimersearch.sh notExists guards)."""
    from ..parallel.distributed import alignment_backend
    from ..search.stages import make_cache
    same_db = qdb.path == tdb.path
    align_fn = alignment_backend(align_all)
    if align_fn is not align_all:
        # several ranks: the chain search + expanded re-align shard by
        # query with an all_gather merge ($RUNNER on multimersearch.sh's
        # stages); stage-resume is single-process-only (rank races)
        cache = None
    else:
        cache = make_cache(tmp_dir, replace(params, add_backtrace=True),
                           qdb, tdb)
    if params.exhaustive_search:
        # EXHAUSTIVE prefmode skips expansion; search carries backtraces
        spar = replace(params, add_backtrace=True)
        with Timer("search"):
            alns = search(qdb, tdb, spar, device, same_db=same_db,
                          tmp_dir=tmp_dir)
    else:
        # initial chain-level search without backtrace, 3Di+AA
        # (MultimerSearch.cpp:104-106 resets addBacktrace/alignmentType)
        spar = replace(params, add_backtrace=False, alignment_type=2)
        with Timer("search"):
            hits_aln = search(qdb, tdb, spar, device, same_db=same_db,
                              tmp_dir=tmp_dir)

        def run_expand_align():
            hits = {qk: [r.db_key for r in rs] for qk, rs in hits_aln.items()}
            with Timer("expandmultimer"):
                expanded = expand_multimer(qdb, tdb, hits)
            # re-align every expanded chain pair with the relaxed e-value.
            # comp-bias-corr-scale is 1.0 here, NOT the search default 0.5:
            # MultimerSearch.cpp serializes MULTIMER_ALIGN_PAR from the raw
            # LocalParameters (structureAlignDefault's 0.5 override only
            # applies to the standalone structurealign command), so the
            # reference's expand re-align runs with the scale-1.0 bias —
            # the source of the r4 "multimer TM band" (different profile ->
            # one fewer/more matched pair on near-tie chain alignments)
            apar = replace(params, add_backtrace=True,
                           evalue_thr=EVALUE_THR_EXPAND_MULTIMER,
                           comp_bias_correction_scale=1.0)
            with Timer("structurealign expand"):
                return align_fn(qdb, tdb, expanded, apar, device,
                                same_db=same_db)
        alns = (cache.run_aln("aln_expand", run_expand_align)
                if cache is not None else run_expand_align())
    with Timer("scoremultimer"):
        return score_multimer(qdb, tdb, alns, filter_params=filter_params)


def easy_multimer_search(query_input: str, target_input: str,
                         output_prefix: str, tmp_dir: str,
                         params: SearchParams,
                         device: torch.device) -> List[str]:
    """createdb -> multimersearch -> report. Returns report lines; writes
    <prefix>_report (data/easymultimersearch.sh:49-55)."""
    os.makedirs(tmp_dir, exist_ok=True)
    qdb = ensure_db(query_input, tmp_dir, "query")
    same_input = os.path.abspath(query_input) == os.path.abspath(target_input)
    tdb = qdb if same_input else ensure_db(target_input, tmp_dir, "target")
    score_results = multimer_search(qdb, tdb, params, device,
                                    tmp_dir=tmp_dir)
    report = create_multimer_report(qdb, tdb, score_results)
    report_path = output_prefix + "_report"
    with open(report_path, "w") as f:
        for line in report:
            f.write(line + "\n")
    logger.info("easy-multimersearch: %d assignments -> %s",
                len(report), report_path)
    return report

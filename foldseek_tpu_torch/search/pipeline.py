"""Search workflows of the port: easy-search / search as an in-process stage
graph (reference: data/structuresearch.sh, data/easystructuresearch.sh,
src/workflow/StructureSearch.cpp).

Port of `foldseek_tpu/search/pipeline.py` for one process: with a tmp dir,
the prefilter and align stages persist their artifacts through
`search/stages.py` and a re-invoked run resumes from them. Every
entry point takes the torch device the stages run on.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..db import StructDB, create_db, is_db, load_db
from ..utils.log import Timer, logger
from .align import align_all
from .convertalis import format_results, needs_backtrace, write_output
from .params import PREF_MODE_UNGAPPED_AND_GAPPED, SearchParams
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


def check_supported(params: SearchParams) -> None:
    """Raise NotImplementedError for what this port does not cover yet."""
    if params.cluster_search:
        raise NotImplementedError(
            "--cluster-search is not ported yet (ROADMAP queue 1, item 14)")
    if params.num_iterations > 1:
        raise NotImplementedError(
            "--num-iterations > 1 (iterative profile search) is not ported "
            "yet (ROADMAP queue 1, item 12)")
    if params.alignment_type in (1, 3):
        raise NotImplementedError(
            f"--alignment-type {params.alignment_type} is not ported yet "
            "(ROADMAP queue 1, item 13)")


def search(qdb: StructDB, tdb: StructDB, params: SearchParams,
           device: torch.device, same_db: Optional[bool] = None,
           tmp_dir: Optional[str] = None) -> Dict[int, List[AlnResult]]:
    check_supported(params)
    if same_db is None:
        same_db = qdb.path == tdb.path
    cache = make_cache(tmp_dir, params, qdb, tdb)
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
    def run():
        with Timer("structurealign"):
            return align_all(qdb, tdb, pref, params, device, same_db=same_db)
    if cache is not None:
        # backtraces are always persisted: a resumed run must reproduce the
        # in-memory records
        return cache.run_aln("aln", run)
    return run()


def easy_search(query_input: str, target_input: str, out_path: str,
                tmp_dir: str, params: SearchParams,
                device: torch.device) -> List[str]:
    check_supported(params)
    os.makedirs(tmp_dir, exist_ok=True)
    qdb = ensure_db(query_input, tmp_dir, "query")
    same_input = os.path.abspath(query_input) == os.path.abspath(target_input)
    tdb = qdb if same_input else ensure_db(target_input, tmp_dir, "target")
    params.add_backtrace = (params.add_backtrace
                            or needs_backtrace(params.format_output)
                            or params.format_mode in (1, 2, 3, 5))
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

"""Reciprocal best hit — rbh / easy-rbh
(reference: src/workflow/StructureRbh.cpp, data/structurerbh.sh,
lib/mmseqs/src/util/result2rbh.cpp).

Pipeline: search A vs B and B vs A (structure-bit sorting off,
StructureRbh.cpp:13-21); per query a merge its single best A->B target with
every b whose co-best B->A hit points at a; re-align all merged candidates
from A's side with structurealign at e=1e8; a target is an RBH partner when
its re-aligned score ties the top merged line — which happens exactly when
it entered the list from both directions (result2rbh.cpp:33-75).

Copy of `foldseek_tpu/search/rbh.py`: both searches and the re-align run on
the torch device the caller names.
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List

import torch

from ..db.storage import StructDB
from ..utils.log import logger
from .align import align_all
from .params import SearchParams
from .pipeline import ensure_db, search
from .results import AlnResult


def swap_coverage_mode(cov_mode: int) -> int:
    """Util::swapCoverageMode: query <-> target."""
    if cov_mode == 1:
        return 2
    if cov_mode == 2:
        return 1
    return cov_mode


def rbh(adb: StructDB, bdb: StructDB, params: SearchParams,
        device: torch.device) -> Dict[int, List[AlnResult]]:
    p2 = replace(params, sort_by_structure_bits=False)
    res_ab = search(adb, bdb, p2, device, same_db=False)
    res_ba = search(bdb, adb, replace(p2, cov_mode=swap_coverage_mode(p2.cov_mode)),
                    device, same_db=False)

    # merged candidate lists: A's best target first, then swapped co-best
    # B->A hits (mergedbs order, then filterdb sort by score desc — stable,
    # so the A-side line leads on ties)
    cand: Dict[int, List] = {int(k): [] for k in adb.keys}
    for a, rs in res_ab.items():
        if rs:
            best = max(rs, key=lambda r: r.score)
            cand[int(a)].append((best.score, 0, best.db_key))
    for b, rs in res_ba.items():
        if not rs:
            continue
        first_score = rs[0].score  # --beats-first vs the first line's score
        for r in rs:
            if r.score == first_score:
                cand[r.db_key].append((r.score, 1, int(b)))
    merged = {}
    for a, lst in cand.items():
        lst.sort(key=lambda x: (-x[0], x[1]))
        merged[a] = [b for _, _, b in lst]

    # re-align everything from A's side (rbh.sh:82-85): e-value gate 1e8;
    # ALIGNMENT_PAR is the base align list, so the spawned structurealign
    # falls back to comp-bias scale 1.0 and default structure-bit sorting
    repar = replace(params, evalue_thr=1e8, comp_bias_correction_scale=1.0,
                    sort_by_structure_bits=True)
    realigned = align_all(adb, bdb, merged, repar, device, same_db=False)

    # result2rbh: first line is consumed as "A's best"; following lines with
    # the same score are the reciprocal best hits
    out: Dict[int, List[AlnResult]] = {int(k): [] for k in adb.keys}
    for a, rs in realigned.items():
        if not rs:
            continue
        best_score = rs[0].score
        for r in rs[1:]:
            if r.score != best_score:
                break
            out[int(a)].append(r)
    return out


def easy_rbh(query_input: str, target_input: str, out_path: str,
             tmp_dir: str, params: SearchParams,
             device: torch.device) -> List[str]:
    from .convertalis import format_results, needs_backtrace
    os.makedirs(tmp_dir, exist_ok=True)
    adb = ensure_db(query_input, tmp_dir, "query")
    bdb = ensure_db(target_input, tmp_dir, "target")
    params.add_backtrace = params.add_backtrace or needs_backtrace(params.format_output)
    results = rbh(adb, bdb, params, device)
    lines = format_results(adb, bdb, results, params.format_output,
                           with_backtrace=params.add_backtrace)
    with open(out_path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    logger.info("easy-rbh: %d reciprocal best hits -> %s", len(lines), out_path)
    return lines

"""lolalign alignment stage: alignment-type 3 — re-align prefilter hits with
the Local-distance Log-odds aligner (reference: src/strucclustutils/
tmalign.cpp runStructureAligner(runLoLAlign=true)).

Result mapping: evalue = qq-normalized LoL score (hit order), bits = the
raw-normalized score; every hit passes the TM gate (tmalign.cpp:352-354).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..db.storage import StructDB
from ..ops.lolalign import LoLAligner
from ..ops.matrices import blosum62
from ..utils.log import logger
from .params import SearchParams, can_be_covered, has_coverage
from .results import AlnResult

FLT_EPSILON = float(np.finfo(np.float32).eps)


def lolalign_all(qdb: StructDB, tdb: StructDB,
                 prefilter: Dict[int, Sequence[int]],
                 params: SearchParams, same_db: bool) -> Dict[int, List[AlnResult]]:
    tkey_to_idx = tdb.key_to_index()
    qkey_to_idx = qdb.key_to_index()
    # The workflow invokes the lolalign module WITHOUT forwarding
    # --alignment-type (createParameterString(par.lolalign),
    # StructureSearch.cpp:143), so the module's own alignmentType stays at
    # its default 2 and aaFactor is always 1.4 (tmalign.cpp:51) — the AA
    # matrix is blosum at bit factor 1.4, then computeDiScore multiplies by
    # 1.4 again (LoLAlign.cpp:723).
    sub_aa = blosum62(1.4).scores.astype(np.float32)
    multi_domain = True  # --lolalign-multidomain default 1 (LocalParameters.cpp:365)
    # thread-parallel over queries (reference: omp-for over queries); the
    # FwBw forward matrices run in the native lib (GIL released)
    from ..utils.hostpar import map_queries

    def one(qkey_cands):
        qkey, cand_keys = qkey_cands
        qi = qkey_to_idx[int(qkey)]
        q_len = qdb.entry_len(qi)
        lol = LoLAligner(multi_domain=multi_domain)
        lol.init_query(qdb.get_ca(qi), qdb.get_aa(qi), qdb.get_ss(qi), sub_aa)
        results: List[AlnResult] = []
        for tkey in cand_keys:
            ti = tkey_to_idx[int(tkey)]
            t_len = tdb.entry_len(ti)
            r = lol.align(tdb.get_ca(ti), tdb.get_aa(ti), tdb.get_ss(ti))
            if r is None:
                continue
            res = AlnResult(
                db_key=int(tkey), score=int(r.score),
                seq_id=float(np.float32(r.seq_id)), evalue=float(r.norm_score),
                q_start=r.q_start, q_end=r.q_end, q_len=q_len,
                t_start=r.t_start, t_end=r.t_end, t_len=t_len,
                backtrace=r.backtrace, qcov=r.qcov, tcov=r.tcov,
                aln_length=len(r.backtrace),
                identical=int(round(r.seq_id * r.backtrace.count("M"))))
            if (has_coverage(params.cov_thr, params.cov_mode, r.qcov, r.tcov)
                    and r.seq_id >= params.seq_id_thr - FLT_EPSILON):
                results.append(res)
        results.sort(key=lambda r: (-r.evalue, -r.score, r.t_len, r.db_key))
        return int(qkey), results

    return dict(map_queries(one, prefilter.items()))

"""tmalign alignment stage: alignment-type 1 — re-align prefilter hits with
full TM-align (reference: src/strucclustutils/tmalign.cpp:141-380).

Result record mapping (tmalign.cpp:310-335, TMaligner.cpp:320-328):
score = int(qTM * 100), evalue = hit-order TM (avg of qTM/tTM by default),
ordered by (evalue desc, score desc, targetLen asc, key asc).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..db.storage import StructDB
from ..ops.tmalign import tmalign
from ..utils.log import logger
from .params import SearchParams, can_be_covered, has_coverage
from .results import AlnResult

TMALIGN_HIT_ORDER_AVG = 0
TMALIGN_HIT_ORDER_QUERY = 1
TMALIGN_HIT_ORDER_TARGET = 2
TMALIGN_HIT_ORDER_MIN = 3
TMALIGN_HIT_ORDER_MAX = 4

FLT_EPSILON = float(np.finfo(np.float32).eps)


def tmalign_query(qdb: StructDB, tdb: StructDB, qi: int,
                  cand_keys: Sequence[int], params: SearchParams,
                  tkey_to_idx, same_db: bool,
                  hit_order: int = TMALIGN_HIT_ORDER_AVG,
                  tm_align_fast: bool = True) -> List[AlnResult]:
    q_ca = qdb.get_ca(qi)
    q_aa = np.asarray(qdb.get_aa(qi))
    q_len = len(q_aa)
    results: List[AlnResult] = []
    passed = 0
    rejected = 0
    for tkey in cand_keys:
        if passed >= params.max_accept or rejected >= params.max_rejected:
            break
        ti = tkey_to_idx[int(tkey)]
        is_identity = (qi == ti) and (same_db or params.include_identity)
        if is_identity:
            r = AlnResult(db_key=int(tkey), score=100, seq_id=1.0, evalue=1.0,
                          q_start=0, q_end=q_len - 1, q_len=q_len,
                          t_start=0, t_end=q_len - 1, t_len=q_len,
                          backtrace="M" * q_len, qcov=1.0, tcov=1.0,
                          aln_length=q_len, identical=q_len, tm=1.0)
            results.append(r)
            passed += 1
            rejected = 0
            continue
        t_len = tdb.entry_len(ti)
        if not can_be_covered(params.cov_thr, params.cov_mode, q_len, t_len):
            rejected += 1
            continue
        res = tmalign(q_ca, tdb.get_ca(ti), q_aa, np.asarray(tdb.get_aa(ti)),
                      fast=tm_align_fast)
        if res is None:
            rejected += 1
            continue
        q_tm, t_tm = res.tm_query, res.tm_target
        if hit_order == TMALIGN_HIT_ORDER_AVG:
            order_tm = (q_tm + t_tm) / 2.0
        elif hit_order == TMALIGN_HIT_ORDER_QUERY:
            order_tm = q_tm
        elif hit_order == TMALIGN_HIT_ORDER_TARGET:
            order_tm = t_tm
        elif hit_order == TMALIGN_HIT_ORDER_MIN:
            order_tm = min(q_tm, t_tm)
        else:
            order_tm = max(q_tm, t_tm)
        aln_len = len(res.backtrace)
        seq_id = res.identical / aln_len if aln_len else 0.0
        qcov = (res.q_end - res.q_start + 1) / q_len
        tcov = (res.t_end - res.t_start + 1) / t_len
        r = AlnResult(db_key=int(tkey), score=int(q_tm * 100.0),
                      seq_id=float(np.float32(seq_id)), evalue=float(order_tm),
                      q_start=res.q_start, q_end=res.q_end, q_len=q_len,
                      t_start=res.t_start, t_end=res.t_end, t_len=t_len,
                      backtrace=res.backtrace, qcov=qcov, tcov=tcov,
                      aln_length=aln_len, identical=res.identical,
                      tm=q_tm, u=res.u, t=res.t)
        if (has_coverage(params.cov_thr, params.cov_mode, qcov, tcov)
                and seq_id >= params.seq_id_thr - FLT_EPSILON
                and order_tm >= params.tmscore_threshold):
            results.append(r)
            passed += 1
            rejected = 0
        else:
            rejected += 1
    # compareHitsByScore (tmalign.cpp:19-30)
    results.sort(key=lambda r: (-r.evalue, -r.score, r.t_len, r.db_key))
    return results


def tmalign_all(qdb: StructDB, tdb: StructDB,
                prefilter: Dict[int, Sequence[int]],
                params: SearchParams, same_db: bool) -> Dict[int, List[AlnResult]]:
    tkey_to_idx = tdb.key_to_index()
    qkey_to_idx = qdb.key_to_index()
    # thread-parallel over queries (reference: omp-for, tmalign.cpp:219);
    # the iterative TM search runs in the native lib (GIL released)
    from ..utils.hostpar import map_queries

    def one(qkey_cands):
        qkey, cand_keys = qkey_cands
        return int(qkey), tmalign_query(
            qdb, tdb, qkey_to_idx[int(qkey)], cand_keys, params,
            tkey_to_idx, same_db,
            hit_order=params.tmalign_hit_order,
            tm_align_fast=params.tmalign_fast)

    return dict(map_queries(one, prefilter.items()))

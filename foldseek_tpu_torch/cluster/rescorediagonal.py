"""structurerescorediagonal: ungapped 3Di+AA rescoring along a prefilter
diagonal (reference: src/strucclustutils/structurerescorediagonal.cpp).

Per (query, target, diagonal): best local ungapped segment of summed
3Di(2.1-bit) + AA(1.4-bit) substitution scores along the diagonal, with a
reversed-query null subtraction, E-value/coverage/seqId gates, emitted as
alignment records sorted by Matcher::compareHits.

The reverse pass for negative diagonals reproduces the reference verbatim,
including its argument mix-up (structurerescorediagonal.cpp:96-100 passes
the reversed query AA track where the target 3Di track belongs); parity
with reference output requires keeping that behavior.

The diagonal scan is a Kadane max-subarray with exact reference position
semantics (first strict maximum wins, segment starts after the last
non-positive prefix), vectorized over numpy; batching across candidate
pairs happens one pair at a time on the host — the arrays are tiny compared
with the gapped SW stage this feeds. Copy of
`foldseek_tpu/cluster/rescorediagonal.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..db.storage import StructDB
from ..nn.evalue import EvalueComputer
from ..ops.matrices import blosum62, mat3di
from ..utils.log import logger
from .clust import USHRT_MAX
from ..search.params import SearchParams, can_be_covered, has_coverage
from ..search.results import AlnResult, compare_hits, compute_aln_length


@dataclass
class _Local:
    start: int
    end: int
    score: int


def _ungapped(v: np.ndarray) -> _Local:
    """Exact port of the templated ungappedAlignment loop
    (structurerescorediagonal.cpp:23-50) on a precomputed per-position
    score vector v = sub3Di + subAA."""
    if len(v) == 0:
        return _Local(0, 0, 0)
    s = np.cumsum(v.astype(np.int64))
    prefix_min = np.minimum.accumulate(np.concatenate(([0], s)))[:-1]
    running = np.maximum(s - prefix_min, 0)
    max_score = int(running.max())
    if max_score <= 0:
        return _Local(0, 0, 0)
    end = int(np.argmax(running))  # first strict max
    nonpos = np.nonzero(running[:end] <= 0)[0]
    start = int(nonpos[-1]) + 1 if len(nonpos) else 0
    return _Local(start, end, max_score)


class DiagonalRescorer:
    def __init__(self, qdb: StructDB, tdb: StructDB, params: SearchParams):
        self.qdb = qdb
        self.tdb = tdb
        self.params = params
        aa_factor = 1.4 if params.alignment_type == 2 else 0.0
        self.sub3di = mat3di(2.1).scores.astype(np.int32)
        self.subaa = blosum62(aa_factor).scores.astype(np.int32)
        self.ev = EvalueComputer(tdb.total_residues)
        self.tkey_to_idx = tdb.key_to_index()
        self.qkey_to_idx = qdb.key_to_index()

    def _pair_scores(self, q3di, qaa, t3di, taa) -> np.ndarray:
        return self.sub3di[q3di, t3di] + self.subaa[qaa, taa]

    def rescore_query(self, qkey: int,
                      hits: Sequence,  # (target_key, diagonal) pairs
                      same_db: bool) -> List[AlnResult]:
        par = self.params
        qi = self.qkey_to_idx[int(qkey)]
        q_aa = np.asarray(self.qdb.get_aa(qi))
        q_ss = np.asarray(self.qdb.get_ss(qi))
        q_len = len(q_aa)
        qr_aa = q_aa[::-1]
        qr_ss = q_ss[::-1]
        lam, mu = self.ev.predict_lambda_mu(q_ss)

        results: List[AlnResult] = []
        passed = 0
        rejected = 0
        for tkey, diagonal in hits:
            if passed >= par.max_accept or rejected >= par.max_rejected:
                break
            ti = self.tkey_to_idx[int(tkey)]
            t_len = self.tdb.entry_len(ti)
            is_identity = (qi == ti and same_db) or (qi == ti and par.include_identity)
            if not can_be_covered(par.cov_thr, par.cov_mode, q_len, t_len):
                rejected += 1
                continue
            t_aa = np.asarray(self.tdb.get_aa(ti))
            t_ss = np.asarray(self.tdb.get_ss(ti))
            # the diagonal arrives as the reference's short-typed value
            diagonal = int(np.int16(diagonal))
            dist = abs(diagonal)

            res = _Local(0, 0, 0)
            score = 0
            if diagonal >= 0 and dist < q_len:
                n = min(t_len, q_len - dist)
                fwd = _ungapped(self._pair_scores(q_ss[dist:dist + n], q_aa[dist:dist + n],
                                                  t_ss[:n], t_aa[:n]))
                rev = _ungapped(self._pair_scores(qr_ss[dist:dist + n], qr_aa[dist:dist + n],
                                                  t_ss[:n], t_aa[:n]))
                res = fwd
                score = fwd.score - rev.score
            elif diagonal < 0 and dist < t_len:
                n = min(t_len - dist, q_len)
                fwd = _ungapped(self._pair_scores(q_ss[:n], q_aa[:n],
                                                  t_ss[dist:dist + n], t_aa[dist:dist + n]))
                # reference quirk (:96-100): the "3Di" track of the second
                # sequence is the reversed-query AA numbering, the AA track
                # pairs the forward query against the target. When
                # dist+n > q_len the reference reads past the reversed query
                # buffer (UB); clamp to the in-bounds prefix instead.
                n2 = min(n, q_len - dist) if dist < q_len else 0
                rev_sc = (self.sub3di[qr_ss[:n2], qr_aa[dist:dist + n2]]
                          + self.subaa[q_aa[:n2], t_aa[dist:dist + n2]])
                rev = _ungapped(rev_sc) if n2 > 0 else _Local(0, 0, 0)
                res = fwd
                score = fwd.score - rev.score
            # else: out-of-range diagonal keeps the zero-initialized result

            evalue = self.ev.evalue_corr(score, lam, mu)
            if diagonal >= 0:
                q_start, q_end = res.start + dist, res.end + dist
                t_start, t_end = res.start, res.end
            else:
                q_start, q_end = res.start, res.end
                t_start, t_end = res.start + dist, res.end + dist
            aln_len = compute_aln_length(q_start, q_end, t_start, t_end)
            qcov = (q_end - q_start + 1) / q_len
            tcov = (t_end - t_start + 1) / t_len
            if not has_coverage(par.cov_thr, par.cov_mode, qcov, tcov):
                rejected += 1
                continue
            if evalue > par.evalue_thr:
                rejected += 1
                continue
            id_cnt = int((q_aa[q_start:q_end + 1] == t_aa[t_start:t_start + (q_end - q_start) + 1]).sum())
            seq_id = id_cnt / aln_len if aln_len else 0.0

            r = AlnResult(
                db_key=int(tkey), score=int(score), seq_id=float(np.float32(seq_id)),
                evalue=float(evalue),
                q_start=q_start, q_end=q_end, q_len=q_len,
                t_start=t_start, t_end=t_end, t_len=t_len,
                backtrace="M" * aln_len if par.add_backtrace else "",
                qcov=qcov, tcov=tcov, aln_length=aln_len, identical=id_cnt)

            ok = is_identity or (
                r.evalue <= par.evalue_thr
                and r.seq_id >= par.seq_id_thr
                and r.aln_length >= par.aln_len_thr
                and has_coverage(par.cov_thr, par.cov_mode, qcov, tcov))
            if ok:
                results.append(r)
                passed += 1
                rejected = 0
            else:
                rejected += 1

        if len(results) > 1:
            results.sort(key=compare_hits)
        return results


def rescore_all(qdb: StructDB, tdb: StructDB,
                prefilter: Dict[int, List],
                params: SearchParams, same_db: bool) -> Dict[int, List[AlnResult]]:
    """prefilter: query key -> [(target_key, diagonal), ...]"""
    rescorer = DiagonalRescorer(qdb, tdb, params)
    out: Dict[int, List[AlnResult]] = {}
    for qkey, hits in prefilter.items():
        out[int(qkey)] = rescorer.rescore_query(qkey, hits, same_db)
    return out

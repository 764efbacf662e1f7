"""What a GPU search of one query against the DB has to report, worked out
from the generated letters alone.

Mode 1 (`--gpu 1`: ungapped prefilter, then structurealign): the prefilter
keeps targets whose ungapped score exceeds 15, the `max_seqs` best by
(score desc, key asc); the 3Di+AA SW of each kept target, less the SW score
of the reversed query, is the raw score; a target is reported when the
E-values of its forward score and of its raw score are both within the
limit. Mode 3 (`--prefilter-mode 3`): the 3Di SW of every target; targets
scoring above 15 with an E-value within the limit, ordered by (E-value,
-score, target length, key) and cut at `max_seqs`.

Keys are entry indices: the harness numbers the DB's entries 0..n-1.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import dp
from .scoring import (MIN_DIAG_SCORE, Evalue, dual_profile, ungapped_profile)


def prefilter_candidates(ss_q, tables: dp.TargetTables,
                         max_seqs: int) -> np.ndarray:
    prof, cap = ungapped_profile(ss_q)
    s = dp.ungapped_all(prof, cap, tables, ss_q)
    ok = np.flatnonzero(s > MIN_DIAG_SCORE)
    order = np.lexsort((ok, -s[ok]))[:max_seqs]
    return ok[order]


def mode1(q_aa, q_ss, db, tables: dp.TargetTables, params: Dict,
          device, sat: Optional[int] = None) -> Dict[int, dict]:
    """target key -> {raw, fwd, q_end, t_end, evalue} of every target the
    search must report for this query. `sat` saturates the SW scores
    (the control)."""
    cands = prefilter_candidates(q_ss, tables, params["max_seqs"])
    t_aa = [db.aa[db.offsets[t]:db.offsets[t + 1]] for t in cands]
    t_ss = [db.ss[db.offsets[t]:db.offsets[t + 1]] for t in cands]
    fwd = dual_profile(q_aa, q_ss)
    rev = dual_profile(np.asarray(q_aa)[::-1], np.asarray(q_ss)[::-1])
    out = dp.sw_pairs([fwd, rev], t_aa, t_ss, device, sat=sat)
    ev = Evalue.of(q_ss, int(db.offsets[-1]))
    thr = params["evalue_thr"]
    hits = {}
    for k, t in enumerate(cands):
        f, r = int(out[0, 0, k]), int(out[1, 0, k])
        e = ev(f - r)
        if ev(f) <= thr and e <= thr:
            hits[int(t)] = dict(raw=f - r, fwd=f, q_end=int(out[0, 1, k]),
                                t_end=int(out[0, 2, k]), evalue=e)
    return hits


def mode3(q_ss, db, tables: dp.TargetTables, params: Dict,
          sat: Optional[int] = None) -> list:
    """Ordered [{key, score, q_end, t_end, evalue}] the search must report."""
    prof, _cap = ungapped_profile(q_ss)
    s, qe, te = dp.sw_all(prof, q_ss, tables, sat=sat)
    ev = Evalue.of(q_ss, int(db.offsets[-1]))
    ok = np.flatnonzero(s > MIN_DIAG_SCORE)
    distinct, inv = np.unique(s[ok], return_inverse=True)
    e = np.array([ev(v) for v in distinct], dtype=np.float64)[inv]
    keep = e <= params["evalue_thr"]
    ok, e = ok[keep], e[keep]
    lens = np.diff(db.offsets)
    order = np.lexsort((ok, lens[ok], -s[ok], e))[: params["max_seqs"]]
    return [dict(key=int(ok[j]), score=int(s[ok[j]]), q_end=int(qe[ok[j]]),
                 t_end=int(te[ok[j]]), evalue=float(e[j])) for j in order]

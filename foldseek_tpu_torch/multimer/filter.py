"""Multimer assignment filtering — the scoremultimer filter stage used by
multimercluster (reference: src/strucclustutils/scoremultimer.cpp
ComplexFilter :737-1100).

Per assignment: complex TM and coverage gates, per-chain TM recomputed under
the assignment's single superposition, and interface LDDT over query
residues within 8 A of another chain. Per target complex only the best
assignment (by truncated mean coverage — effectively the first, highest-TM
one) survives. Copy of `foldseek_tpu/multimer/filter.py` over the port's
host LDDT (`ops/lddt.py` compute_lddt).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..db.storage import StructDB
from ..ops import lddt as lddt_ops
from ..search.results import expand_backtrace
from .scoremultimer import Assignment

INTERFACE_THRESHOLD = 8.0


@dataclass
class MultimerFilterParams:
    mult_tm_thr: float = 0.0
    chain_tm_thr: float = 0.0
    interface_lddt_thr: float = 0.0
    cov_thr: float = 0.0
    cov_mode: int = 0
    min_aligned_chains: int = 2

    @property
    def active(self) -> bool:
        return (self.mult_tm_thr + self.chain_tm_thr
                + self.interface_lddt_thr) > 0


def compute_interface_regions(qdb: StructDB, q_chains: List[int],
                              key_to_idx) -> Dict[int, np.ndarray]:
    """Per query chain: residue indices within 8 A of any other chain
    (ComplexFilter::computeInterfaceRegion)."""
    out = {}
    coords = {k: np.asarray(qdb.get_ca(key_to_idx[k]), dtype=np.float32)
              for k in q_chains}
    d2 = INTERFACE_THRESHOLD * INTERFACE_THRESHOLD
    for k in q_chains:
        a = coords[k]
        iface = np.zeros(len(a), dtype=bool)
        for k2 in q_chains:
            if k2 == k:
                continue
            b = coords[k2]
            dist2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            iface |= (dist2 < d2).any(axis=1)
        out[k] = np.nonzero(iface)[0]
    return out


def _parse_chain_line(line: str):
    c = line.split("\t")
    return {
        "t_key": int(c[0]),
        "q_start": int(c[4]), "q_end": int(c[5]), "q_len": int(c[6]),
        "t_start": int(c[7]), "t_end": int(c[8]), "t_len": int(c[9]),
        "backtrace": expand_backtrace(c[10]),
    }


def filter_assignment(assignment: Assignment, q_chains: List[int],
                      interface: Dict[int, np.ndarray],
                      t_chain_to_complex: Dict[int, int],
                      t_complex_chains: Dict[int, List[int]],
                      fp: MultimerFilterParams) -> Optional[Tuple[int, int]]:
    """Apply the filter gates; on success sets assignment.filter_result and
    returns (target complex id, truncated adjusted alignment length)."""
    a = assignment
    n_chains = len(a.chain_results)
    if n_chains < fp.min_aligned_chains:
        return None
    recs = [_parse_chain_line(line) for _, line in a.chain_results]
    t_complex = t_chain_to_complex[recs[0]["t_key"]]
    q_aln_len = sum(abs(r["q_end"] - r["q_start"]) + 1 for r in recs)
    t_aln_len = sum(abs(r["t_end"] - r["t_start"]) + 1 for r in recs)

    # complex TM gate (:955-963)
    if fp.cov_mode == 0 and (a.q_tm < fp.mult_tm_thr or a.t_tm < fp.mult_tm_thr):
        return None
    if fp.cov_mode == 1 and a.t_tm < fp.mult_tm_thr:
        return None
    if fp.cov_mode == 2 and a.q_tm < fp.mult_tm_thr:
        return None

    q_cov = q_aln_len / a.q_res_len
    t_cov = t_aln_len / a.t_res_len
    if fp.cov_mode == 0:
        adjust = int((q_cov + t_cov) / 2)
        if fp.cov_thr > 0 and (q_cov < fp.cov_thr or t_cov < fp.cov_thr):
            return None
    elif fp.cov_mode == 1:
        adjust = int(t_cov)
        if fp.cov_thr > 0 and t_cov < fp.cov_thr:
            return None
    else:
        adjust = int(q_cov)
        if fp.cov_thr > 0 and q_cov < fp.cov_thr:
            return None

    # per-chain TM under the assignment superposition (:985-1042)
    u = np.asarray(a.u, dtype=np.float32)
    t = np.asarray(a.t, dtype=np.float32)
    q_tms, t_tms = [], []
    off = 0
    for i, r in enumerate(recs):
        m = a.match_lens[i]
        tc = a.t_ca[off:off + m].astype(np.float32)
        qc = a.q_ca[off:off + m].astype(np.float32)
        rot = tc @ u.T + t
        d0 = 1.24 * ((r["t_len"] - 15) ** (1.0 / 3.0)) - 1.8 if r["t_len"] > 15 else 0.5
        d02 = np.float32(d0 * d0)
        di = ((qc - rot) ** 2).sum(axis=1)
        tm_sum = float((1.0 / (1.0 + di / d02)).sum())
        q_tms.append(tm_sum / r["q_len"])
        t_tms.append(tm_sum / r["t_len"])
        off += m

    if fp.chain_tm_thr > 0:
        if fp.cov_mode == 0:
            n_t_chains = len(t_complex_chains[t_complex])
            if n_t_chains != len(q_chains) or n_t_chains != n_chains:
                return None
            if any(q < fp.chain_tm_thr for q in q_tms):
                return None
            if any(v < fp.chain_tm_thr for v in t_tms):
                return None
        elif fp.cov_mode == 1:
            if sum(1 for v in t_tms if v >= fp.chain_tm_thr) < fp.min_aligned_chains:
                return None
        else:
            if sum(1 for v in q_tms if v >= fp.chain_tm_thr) < fp.min_aligned_chains:
                return None

    # interface LDDT (:1044-1100)
    interface_lddt = 0.0
    if n_chains == 1 and fp.interface_lddt_thr > 0:
        return None
    if n_chains > 1:
        q_int, t_int = [], []
        whole_int_len = 0
        off = 0
        for i, (q_key, _) in enumerate(a.chain_results):
            r = recs[i]
            m = a.match_lens[i]
            # map query residue -> position in the concatenated match arrays
            qpos_to_cat = {}
            qi, ti = r["q_start"], r["t_start"]
            cat = off
            for op in r["backtrace"]:
                if op == "M":
                    qpos_to_cat[qi] = cat
                    cat += 1
                    qi += 1
                    ti += 1
                elif op == "I":
                    qi += 1
                else:
                    ti += 1
            iface = interface.get(q_key, np.zeros(0, dtype=int))
            whole_int_len += len(iface)
            for res in iface:
                c = qpos_to_cat.get(int(res))
                if c is not None:
                    q_int.append(a.q_ca[c])
                    t_int.append(a.t_ca[c])
            off += m
        if q_int:
            q_arr = np.asarray(q_int, dtype=np.float32)
            t_arr = np.asarray(t_int, dtype=np.float32)
            n = len(q_arr)
            lr = lddt_ops.compute_lddt(q_arr, t_arr, 0, 0, "M" * n)
            interface_lddt = lr.avg_lddt * lr.score_length / max(whole_int_len, 1)
            if interface_lddt < fp.interface_lddt_thr:
                return None
        elif fp.interface_lddt_thr > 0:
            return None

    def f(v):
        # SSTR(float) = "{:.3f}" (Util.cpp:677); all filter fields are
        # floats in the reference (scoremultimer.cpp:1066-1086)
        return f"{np.float32(v):.3f}"

    a.filter_result = "\t".join([
        f(q_cov), f(t_cov),
        ",".join(f(v) for v in q_tms), ",".join(f(v) for v in t_tms),
        f(interface_lddt)])
    return t_complex, adjust

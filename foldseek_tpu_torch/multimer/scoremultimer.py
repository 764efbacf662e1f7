"""scoremultimer: complex (multimer) chain-assignment scoring.

Port of the reference algorithm (reference: src/strucclustutils/scoremultimer.cpp,
src/strucclustutils/MultimerUtil.h):

Per (query complex, target complex): every chain-chain alignment carries its
per-chain TM-score and 12-d superposition vector (rotation u flattened + t).
Alignments are RBH-filtered (keep within TM_SCORE_MARGIN=0.7 of each chain's
best), superposition vectors standardized per dimension, then DBSCAN with a
growing eps over the pairwise superposition distances finds the largest
mutually-compatible chain assignment. Each cluster becomes an Assignment
whose complex TM-score is TMaligner over the concatenated matched residues,
normalized by min/query/target complex residue counts.

The per-chain TM and the assignment TM use the Kabsch/TM routines of
ops.tmscore (numpy, on the host); the DBSCAN bookkeeping is host-side too
(tiny: #alignments per complex pair is #chains^2). Copy of
`foldseek_tpu/multimer/scoremultimer.py`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..db.storage import StructDB
from ..ops import tmscore as tm_ops
from ..search.results import AlnResult, result_to_line
from ..utils.log import logger

TOO_SMALL_MEAN = 1.0
TOO_SMALL_CV = 0.1
FILTERED_OUT = 0.0
MIN_PTS = 2
LEARNING_RATE = 0.1
TM_SCORE_MARGIN = 0.7
MULTIPLE_CHAINED_COMPLEX = 2
SKIP_MONOMERS = 1


def complex_maps(db: StructDB):
    """chainKey->complexId, complexId->[chainKeys], complex order of first
    appearance (MultimerUtil.h getKeyToIdMapIdToKeysMapIdVec over .lookup)."""
    chain_to_complex: Dict[int, int] = {}
    complex_to_chains: Dict[int, List[int]] = {}
    complex_order: List[int] = []
    for i in range(db.size):
        key = int(db.keys[i])
        cid = int(db.fileids[i]) if db.fileids is not None else 0
        chain_to_complex[key] = cid
        if cid not in complex_to_chains:
            complex_to_chains[cid] = []
            complex_order.append(cid)
        complex_to_chains[cid].append(key)
    return chain_to_complex, complex_to_chains, complex_order


@dataclass
class ChainAln:
    """ChainToChainAln: one chain-chain alignment + superposition."""
    q_key: int
    t_key: int
    q_matched_ca: np.ndarray  # [m, 3] matched query CA
    t_matched_ca: np.ndarray  # [m, 3] matched target CA
    matches: int
    tm: float                  # per-chain TM normalized by qLen
    superposition: np.ndarray  # [12] float64 (u flattened + t)
    result_line: str           # serialized alignment record


@dataclass
class Assignment:
    q_res_len: int
    t_res_len: int
    matches: int = 0
    q_ca: Optional[np.ndarray] = None
    t_ca: Optional[np.ndarray] = None
    match_lens: List[int] = field(default_factory=list)
    chain_results: List[Tuple[int, str]] = field(default_factory=list)
    q_tm: float = 0.0
    t_tm: float = 0.0
    u: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    assignment_id: int = 0
    filter_result: str = ""

    def append(self, aln: ChainAln):
        self.matches += aln.matches
        self.q_ca = aln.q_matched_ca if self.q_ca is None else np.concatenate(
            [self.q_ca, aln.q_matched_ca])
        self.t_ca = aln.t_matched_ca if self.t_ca is None else np.concatenate(
            [self.t_ca, aln.t_matched_ca])
        self.match_lens.append(aln.matches)
        self.chain_results.append((aln.q_key, aln.result_line))

    def compute_tm(self) -> bool:
        if self.matches == 0:
            return False
        norm_len = min(self.q_res_len, self.t_res_len)
        res = tm_ops.compute_tm_score(self.q_ca, self.t_ca, 0, 0,
                                      "M" * self.matches, norm_len)
        self.q_tm = res.tmscore * norm_len / self.q_res_len
        self.t_tm = res.tmscore * norm_len / self.t_res_len
        self.u = res.u
        self.t = res.t
        return True

    def result_suffix(self) -> str:
        """'\\tqTm\\ttTm\\tuString\\ttString' with std::to_string (6-dec) floats
        (Assignment::updateResultToWriteLines)."""
        u = self.u
        t = self.t
        ustr = ",".join(f"{u[i][j]:.6f}" for i in range(3) for j in range(3))
        tstr = ",".join(f"{t[i]:.6f}" for i in range(3))
        return f"\t{self.q_tm:.6f}\t{self.t_tm:.6f}\t{ustr}\t{tstr}"


def _standardize(alns: List[ChainAln]):
    """SearchResult::standardize: per superposition dimension (v-mean)/sd,
    zeroed when the coefficient of variation is < 0.1."""
    n = len(alns)
    sup = np.stack([a.superposition for a in alns])  # [n, 12]
    mean = sup.sum(axis=0) / n
    var = ((sup - mean) ** 2).sum(axis=0) / n
    sd = np.sqrt(var)
    cv = np.where(np.abs(mean) > TOO_SMALL_MEAN,
                  sd / np.abs(mean), sd)
    with np.errstate(invalid="ignore", divide="ignore"):
        standardized = (sup - mean) / sd
    out = np.where(cv < TOO_SMALL_CV, FILTERED_OUT, standardized)
    for i, a in enumerate(alns):
        a.superposition = out[i]


class DBSCANCluster:
    """DBSCANCluster (scoremultimer.cpp:243-535) with exact control flow."""

    def __init__(self, alns: List[ChainAln], n_q_chains: int, n_t_chains: int,
                 min_cov: float):
        self.alns = alns
        self.n_q = n_q_chains
        self.n_t = n_t_chains
        self.min_cluster = math.ceil(n_q_chains * min_cov)
        self.max_cluster = min(n_q_chains, n_t_chains)
        self.max_cluster_num = len(alns) // self.max_cluster if self.max_cluster else 0
        self.final: set = set()
        self.prev_max = 0

    def run(self) -> List[Tuple[int, ...]]:
        if min(self.n_q, self.n_t) < MULTIPLE_CHAINED_COMPLEX:
            if self.min_cluster < MULTIPLE_CHAINED_COMPLEX:
                self._single_chained()
            return sorted(self.final)

        self._filter_rbh()
        if not self.alns:
            return []
        self._fill_dist()
        if len(self.alns) <= self.max_cluster:
            self._check_necessity()
            return sorted(self.final)
        self._run_dbscan()
        return sorted(self.final)

    # -- helpers --

    def _single_chained(self):
        self.final = {(i,) for i in range(len(self.alns))}

    def _filter_rbh(self):
        q_best: Dict[int, float] = {}
        t_best: Dict[int, float] = {}
        for a in self.alns:
            q_best[a.q_key] = max(a.tm, q_best.get(a.q_key, -3.4e38))
            t_best[a.t_key] = max(a.tm, t_best.get(a.t_key, -3.4e38))
        kept = []
        q_found, t_found = set(), set()
        for a in self.alns:
            if a.tm < max(q_best[a.q_key], t_best[a.t_key]) * TM_SCORE_MARGIN:
                continue
            kept.append(a)
            q_found.add(a.q_key)
            t_found.add(a.t_key)
        if min(len(q_found), len(t_found)) < self.min_cluster:
            kept = []
        self.alns[:] = kept

    def _fill_dist(self):
        n = len(self.alns)
        sup = np.stack([a.superposition for a in self.alns]).astype(np.float32)
        diff = sup[:, None, :] - sup[None, :, :]
        self.dist = np.sqrt((diff ** 2).sum(axis=-1)).astype(np.float32)
        tri = self.dist[np.triu_indices(n, 1)]
        self.max_dist = float(tri.max()) if len(tri) else -3.4e38
        self.min_dist = float(tri.min()) if len(tri) else 3.4e38
        self.eps = self.min_dist

    def _neighbors(self, center: int) -> List[int]:
        out = [center]
        row = self.dist[center]
        for j in range(len(self.alns)):
            if j != center and row[j] < self.eps:
                out.append(j)
        return out

    def _redundant(self, idxs: Sequence[int]) -> bool:
        qs, ts = set(), set()
        for i in idxs:
            if self.alns[i].q_key in qs:
                return True
            qs.add(self.alns[i].q_key)
            if self.alns[i].t_key in ts:
                return True
            ts.add(self.alns[i].t_key)
        return False

    def _nearest_nonredundant(self, center: int, neighbors: List[int]) -> List[int]:
        with_dist = [(0.0, center)] + [
            (float(self.dist[center][i]), i) for i in neighbors if i != center]
        with_dist.sort(key=lambda x: x[0])
        out = []
        qs, ts = set(), set()
        for _, i in with_dist:
            a = self.alns[i]
            if a.q_key in qs or a.t_key in ts:
                break
            qs.add(a.q_key)
            ts.add(a.t_key)
            out.append(i)
        return out

    def _check_necessity(self):
        if len(self.alns) < self.min_cluster:
            return
        all_idx = list(range(len(self.alns)))
        if self._redundant(all_idx):
            self._run_dbscan()
            return
        self.final.add(tuple(all_idx))

    def _run_dbscan(self):
        while self.eps < self.max_dist:
            labels = [0] * len(self.alns)
            next_label = 0
            curr_max = 0
            curr_clusters: List[Tuple[int, ...]] = []
            for center in range(len(self.alns)):
                if labels[center] != 0:
                    continue
                neighbors = self._neighbors(center)
                if len(neighbors) < MIN_PTS:
                    continue
                next_label += 1
                labels[center] = next_label
                found = set(neighbors)
                k = 0
                while k < len(neighbors):
                    nb = neighbors[k]
                    k += 1
                    if nb == center:
                        continue
                    labels[nb] = next_label
                    nb_neighbors = self._neighbors(nb)
                    if len(nb_neighbors) < MIN_PTS:
                        continue
                    for x in nb_neighbors:
                        if x not in found:
                            found.add(x)
                            neighbors.append(x)
                if len(neighbors) > self.max_cluster or self._redundant(neighbors):
                    neighbors = self._nearest_nonredundant(center, neighbors)
                if len(neighbors) < curr_max:
                    continue
                if len(neighbors) > curr_max:
                    curr_max = len(neighbors)
                    curr_clusters = []
                curr_clusters.append(tuple(sorted(neighbors)))

            if self.final and not curr_clusters:
                return
            if curr_max < self.prev_max:
                return
            if curr_max > self.prev_max:
                self.final.clear()
                self.prev_max = curr_max
            if curr_max >= self.min_cluster:
                self.final.update(curr_clusters)
            if curr_max == self.max_cluster and len(self.final) == self.max_cluster_num:
                return
            self.eps += LEARNING_RATE

        if self.min_cluster < MULTIPLE_CHAINED_COMPLEX and self.prev_max < MULTIPLE_CHAINED_COMPLEX:
            self._single_chained()


def build_chain_aln(q_key: int, t_key: int, res: AlnResult,
                    q_ca: np.ndarray, t_ca: np.ndarray) -> ChainAln:
    """ChainToChainAln constructor: gather matched CA pairs, per-chain TM
    normalized by the query chain length, 12-d superposition vector."""
    qi, ti = res.q_start, res.t_start
    q_idx, t_idx = [], []
    for op in res.backtrace:
        if op == "M":
            q_idx.append(qi)
            t_idx.append(ti)
            qi += 1
            ti += 1
        elif op == "I":
            qi += 1
        else:
            ti += 1
    tmres = tm_ops.compute_tm_score(q_ca, t_ca, res.q_start, res.t_start,
                                    res.backtrace, res.q_len)
    sup = np.empty(12, dtype=np.float64)
    sup[:9] = np.asarray(tmres.u, dtype=np.float32).reshape(9)
    sup[9:] = np.asarray(tmres.t, dtype=np.float32)
    return ChainAln(
        q_key=q_key, t_key=t_key,
        q_matched_ca=np.asarray(q_ca[q_idx], dtype=np.float32),
        t_matched_ca=np.asarray(t_ca[t_idx], dtype=np.float32),
        matches=len(q_idx), tm=float(np.float32(tmres.tmscore)),
        superposition=sup,
        result_line=result_to_line(res, add_backtrace=True))


def score_multimer(qdb: StructDB, tdb: StructDB,
                   alignments: Dict[int, List[AlnResult]],
                   min_assigned_chains_ratio: float = 0.0,
                   monomer_include_mode: int = 0,
                   filter_params=None) -> Dict[int, List[str]]:
    """Returns scorecomplex result lines per query chain key:
    '<alnLine>\\t<qTm>\\t<tTm>\\t<u>\\t<t>[\\t<filterCols>]\\t<assId>'.
    With active filter_params (multimercluster), per target complex only the
    best surviving assignment is emitted (scoremultimer.cpp:1290-1310)."""
    q_c2c, q_complex_chains, q_complex_order = complex_maps(qdb)
    t_c2c, t_complex_chains, t_complex_order = complex_maps(tdb)
    q_key_to_idx = qdb.key_to_index()
    t_key_to_idx = tdb.key_to_index()

    out: Dict[int, List[str]] = {int(k): [] for k in qdb.keys}

    for q_cid in q_complex_order:
        q_chains = q_complex_chains[q_cid]
        if monomer_include_mode == SKIP_MONOMERS and len(q_chains) < MULTIPLE_CHAINED_COMPLEX:
            continue
        q_res_len = sum(qdb.entry_len(q_key_to_idx[k]) for k in q_chains)
        if q_res_len == 0:
            continue
        # chain-pair alignment map
        lines: Dict[Tuple[int, int], AlnResult] = {}
        for qk in q_chains:
            for r in alignments.get(qk, []):
                lines[(qk, r.db_key)] = r
        if not lines:
            continue

        assignments: List[Assignment] = []
        for t_cid in t_complex_order:
            t_chains = t_complex_chains[t_cid]
            t_res_len = sum(tdb.entry_len(t_key_to_idx[k]) for k in t_chains)
            # getSearchResultByDbComplex bails out for the whole complex pair
            # when any query chain lacks an alignment against it (:598-600)
            if any(all((qk, tk) not in lines for tk in t_chains)
                   for qk in q_chains):
                continue
            alns: List[ChainAln] = []
            for qk in q_chains:
                q_ca = qdb.get_ca(q_key_to_idx[qk])
                for tk in t_chains:
                    r = lines.pop((qk, tk), None)
                    if r is None or not r.backtrace:
                        continue
                    t_ca = tdb.get_ca(t_key_to_idx[tk])
                    alns.append(build_chain_aln(qk, tk, r, q_ca, t_ca))
            if not alns:
                continue
            alns.sort(key=lambda a: (a.q_key, a.t_key))
            if t_res_len == 0:
                continue
            if monomer_include_mode == SKIP_MONOMERS and len(t_chains) < MULTIPLE_CHAINED_COMPLEX:
                continue
            _standardize(alns)
            clusters = DBSCANCluster(alns, len(q_chains), len(t_chains),
                                     min(min_assigned_chains_ratio, 1.0)).run()
            for cluster in clusters:
                a = Assignment(q_res_len, t_res_len)
                for idx in cluster:
                    a.append(alns[idx])
                if not a.compute_tm():
                    continue
                assignments.append(a)

        assignments.sort(key=lambda a: (-a.q_tm, -a.t_tm))
        for aid, a in enumerate(assignments):
            a.assignment_id = aid
        if filter_params is not None and filter_params.active:
            from .filter import compute_interface_regions, filter_assignment
            interface = compute_interface_regions(qdb, q_chains, q_key_to_idx)
            best: Dict[int, Tuple[Assignment, int]] = {}
            for a in assignments:
                res = filter_assignment(a, q_chains, interface,
                                        t_c2c, t_complex_chains, filter_params)
                if res is None:
                    continue
                t_cid, adjust = res
                if t_cid not in best or adjust > best[t_cid][1]:
                    best[t_cid] = (a, adjust)
            kept = [best[c][0] for c in sorted(best)]  # std::map order
        else:
            kept = assignments
        for qk in q_chains:
            for a in kept:
                for chain_key, line in a.chain_results:
                    if chain_key != qk:
                        continue
                    suffix = a.result_suffix()
                    if a.filter_result:
                        suffix += "\t" + a.filter_result
                    out[qk].append(f"{line}{suffix}\t{a.assignment_id}")
                    break
    return out

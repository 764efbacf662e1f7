"""Sequence profiles (PSSMs) for both alphabets — result2profile /
result2structprofile and iterative profile search.

Port of the MMseqs2 PSSM pipeline with position-based sequence weighting
(reference: lib/mmseqs/src/alignment/PSSMCalculator.cpp: Henikoff weights
:311-373, match weights :396-410, Neff :283-309, substitution pseudocounts
:274-282,:375-394 with pca 1.1 / pcb 4.1) applied to both the AA and the
3Di tracks (reference: data/result2structprofile.sh). Profiles store
per-position probabilities; integer scores are regenerated at the search
bit scales exactly like substitution matrices (structurealign.cpp:252-265).

Both weighting paths are implemented: the default position-specific
(context-specific HH-suite) weighting (--wg 0,
PSSMCalculator::computeContextSpecificWeights :412-588) and the simple
global-weight path (--wg 1). The MSA redundancy filter
(lib/mmseqs/src/alignment/MsaFilter.cpp:85-556: coverage / qsc /
qid / position-dependent max-pairwise-identity) runs before profile
construction like the reference's --filter-msa 1 default.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..db.storage import StructDB
from ..ops.matrices import blosum62, mat3di
from ..utils.log import logger
from .results import AlnResult

GAP = 255
N_AA = 20
PCA = 1.1
PCB = 4.1


def _build_msa(q_seq: np.ndarray, results: List[AlnResult],
               t_seqs: List[np.ndarray]) -> np.ndarray:
    """Query-length MSA rows (uint8, GAP for gaps): query row + one row per
    hit, target residues placed at matched query columns
    (MultipleAlignment semantics — insertions in the target are dropped)."""
    L = len(q_seq)
    rows = [np.asarray(q_seq, dtype=np.uint8)]
    for r, t_seq in zip(results, t_seqs):
        row = np.full(L, GAP, dtype=np.uint8)
        qi, ti = r.q_start, r.t_start
        for op in r.backtrace:
            if op == "M":
                row[qi] = t_seq[ti]
                qi += 1
                ti += 1
            elif op == "I":
                qi += 1
            else:
                ti += 1
        rows.append(row)
    return np.stack(rows)


def _henikoff_weights(msa: np.ndarray) -> np.ndarray:
    """Global position-based sequence weights, normalized to 1
    (PSSMCalculator::computeSequenceWeights :311-373)."""
    K, L = msa.shape
    valid = msa != GAP
    counted = valid & (msa < N_AA)
    n_res = valid.sum(axis=1).astype(np.float64)
    w = np.full(K, 1e-6)
    for pos in range(L):
        col = msa[:, pos]
        sel = counted[:, pos]
        aa_col = col[sel]
        if len(aa_col) == 0:
            continue
        nl = np.bincount(aa_col, minlength=N_AA)
        distinct = int((nl > 0).sum())
        if distinct == 0:
            continue
        w[sel] += 1.0 / (nl[col[sel]] * distinct * (n_res[sel] + 30.0))
    return w / w.sum()


_ANY = 20      # X
_GAP_I = 21    # internal gap code (MultipleAlignment::GAP)
_ENDGAP = 22


def _context_specific_weights(msa: np.ndarray, w_global: np.ndarray,
                              p_back: np.ndarray):
    """Position-specific sequence weights + per-column Neff
    (PSSMCalculator::computeContextSpecificWeights :412-588).

    Per column i, a subalignment of the sequences with a residue at i is
    weighted 1/(#distinct aa * count) summed over its well-covered columns;
    Neff[i] is the exponentiated mean column entropy of that subalignment.
    Returns (match [L,20] row-normalized with p_back fallback, neff [L])."""
    MAXENDGAPFRAC = 0.1
    NCOLMIN = 20
    K, L = msa.shape
    X = np.where(msa == GAP, _GAP_I, np.minimum(msa, _ANY)).astype(np.int64)
    # leading/trailing gaps become ENDGAP
    for k in range(K):
        j = 0
        while j < L and X[k, j] == _GAP_I:
            X[k, j] = _ENDGAP
            j += 1
        j = L - 1
        while j >= 0 and X[k, j] == _GAP_I:
            X[k, j] = _ENDGAP
            j -= 1
    included = X < _ANY            # [K, L]
    cols = np.arange(L)

    n = np.zeros((L, 23), dtype=np.int64)   # residue counts per column over the subalignment
    wi = np.zeros(K, dtype=np.float64)
    prev_in = np.zeros(K, dtype=bool)
    nseqi = 0
    match = np.zeros((L, N_AA), dtype=np.float64)
    neff = np.zeros(L, dtype=np.float64)

    for i in range(L):
        inc = included[:, i]
        enter = inc & ~prev_in
        leave = prev_in & ~inc
        change = bool(enter.any() or leave.any())
        for k in np.nonzero(enter)[0]:
            np.add.at(n, (cols, X[k]), 1)
        for k in np.nonzero(leave)[0]:
            np.add.at(n, (cols, X[k]), -1)
        nseqi += int(enter.sum()) - int(leave.sum())
        prev_in = inc

        if change:
            endgap_ok = n[:, _ENDGAP] <= MAXENDGAPFRAC * nseqi
            jmin = 0
            while jmin < L and not endgap_ok[jmin]:
                jmin += 1
            jmax = L - 1
            while jmax >= 0 and not endgap_ok[jmax]:
                jmax -= 1
            ncol = jmax - jmin + 1
            if ncol < NCOLMIN:
                wi = np.where(inc, w_global, 0.0)
            else:
                sub = slice(jmin, jmax + 1)
                naa = (n[sub, :N_AA] > 0).sum(axis=1)            # [ncol]
                with np.errstate(divide="ignore"):
                    contrib = np.where(
                        n[sub, :N_AA] > 0,
                        1.0 / (naa[:, None] * n[sub, :N_AA]), 0.0)
                contrib_ext = np.zeros((ncol, 23))
                contrib_ext[:, :N_AA] = contrib
                wi = np.full(K, 1e-8)
                sel = np.nonzero(inc)[0]
                if len(sel):
                    wi[sel] += contrib_ext[
                        np.arange(ncol)[None, :], X[sel, sub]].sum(axis=1)
            # Neff[i] from weighted column frequencies of the subalignment
            sub = slice(jmin, jmax + 1) if ncol > 0 else slice(0, 0)
            f = np.zeros((max(ncol, 0), N_AA), dtype=np.float64)
            sel = np.nonzero(inc)[0]
            for k in sel:
                xs = X[k, sub]
                ok = xs < N_AA
                np.add.at(f, (np.nonzero(ok)[0], xs[ok]), wi[k])
            s = f.sum(axis=1, keepdims=True)
            f = np.divide(f, s, out=np.zeros_like(f), where=s > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                ent = -np.where(f > 1e-10, f * np.log2(f, where=f > 0), 0.0).sum()
            neff[i] = np.exp2(ent / ncol) if ncol > 0 else 1.0
        else:
            neff[i] = neff[i - 1] if i > 0 else 0.0

        # column frequencies from the current wi (persisting across columns)
        col = X[:, i]
        ok = col < N_AA
        np.add.at(match[i], col[ok], wi[ok])
        s = match[i].sum()
        if s > 0:
            match[i] /= s
        else:
            match[i] = p_back[:N_AA] / p_back[:N_AA].sum()
    return match, neff


def msa_filter(msa: np.ndarray, sub_scores: np.ndarray,
               coverage: int = 0, qid: int = 0, qsc: float = -20.0,
               max_seqid: int = 90, ndiff: int = 1000,
               filter_min_enable: int = 0, block: int = 32) -> np.ndarray:
    """MSA redundancy filter -> kept mask [K]; row 0 (query) is always kept
    (MsaFilter::filter, lib/mmseqs/src/alignment/MsaFilter.cpp:85-556).

    block=32 matches the AVX2 build's 32-byte SIMD stride, which widens the
    pairwise-identity window to block boundaries (:446-489)."""
    PLTY_GAPOPEN, PLTY_GAPEXTD = 6.0, 1.0
    WFIL = 25
    K, L = msa.shape
    X = np.where(msa == GAP, _GAP_I, np.minimum(msa, _ANY)).astype(np.int64)
    keep = np.ones(K, dtype=np.int8)
    keep[0] = 2
    if K < filter_min_enable:
        return keep > 0

    aa = X < N_AA
    first = np.argmax(aa, axis=1)
    last = L - 1 - np.argmax(aa[:, ::-1], axis=1)
    first = np.where(aa.any(axis=1), first, 0)
    last = np.where(aa.any(axis=1), last, 0)
    nres = aa.sum(axis=1)
    keep[nres == 0] = 0

    # coverage / qsc / qid gates vs the query (:256-318)
    q = X[0]
    for k in range(1, K):
        if keep[k] == 0:
            continue
        if 100 * nres[k] < coverage * L:
            keep[k] = 0
            continue
        if qsc > -10:
            qsc_sum = 0.0
            gapq = gapk = 0
            for i in range(first[k], last[k] + 1):
                if X[k, i] < N_AA:
                    gapk = 0
                    if q[i] < N_AA:
                        gapq = 0
                        qsc_sum += float(sub_scores[q[i], X[k, i]])
                    elif q[i] == _ANY:
                        continue
                    else:
                        qsc_sum -= PLTY_GAPEXTD if gapq else PLTY_GAPOPEN
                        gapq += 1
                elif X[k, i] == _ANY:
                    continue
                elif q[i] < N_AA:
                    gapq = 0
                    qsc_sum -= PLTY_GAPEXTD if gapk else PLTY_GAPOPEN
                    gapk += 1
            if qsc_sum < qsc * nres[k]:
                keep[k] = 0
                continue
        qdiff_max_frac = 0.9999 - 0.01 * qid
        if qdiff_max_frac < 0.999:
            qdiff_max = int(qdiff_max_frac * nres[k] + 0.9999)
            span = slice(first[k], last[k] + 1)
            diff = int(((X[k, span] < N_AA) & (X[k, span] != q[span])).sum())
            if diff >= qdiff_max:
                keep[k] = 0
                continue

    if not (keep > 0).any():
        keep[0] = 1

    # position-dependent max-pairwise-identity pass (:352-520). With the
    # default Ndiff >= K this collapses to a single sweep at max_seqid.
    if ndiff <= 0 or ndiff >= K:
        seqid1 = max_seqid
        ndiff = K
    else:
        seqid1 = 20
    if seqid1 > max_seqid:
        return keep > 0

    order = np.concatenate([[0], 1 + np.argsort(-nres[1:], kind="stable")])
    in_k = (keep == 2).astype(np.int8)
    N = np.zeros(L, dtype=np.int64)
    N[first[0]:last[0] + 1] = 1
    Nmax = np.zeros(L, dtype=np.int64)
    idmaxwin = np.full(L, -1, dtype=np.int64)
    seqid_prev = np.full(K, -1, dtype=np.int64)
    inkk = in_k[order].copy()
    seqid = seqid1
    seqid_step = 0
    diffNmax = ndiff
    while seqid <= max_seqid:
        stop = True
        diffNmax_prev = diffNmax
        diffNmax = 0
        for i in range(L):
            lo = max(0, min(L - 2 * WFIL + 1, i - WFIL))
            hi = min(L, max(2 * WFIL, i + WFIL))
            m = int(N[lo:hi].max()) if hi > lo else 0
            if Nmax[i] < m:
                Nmax[i] = m
            if Nmax[i] < ndiff:
                stop = False
                idmaxwin[i] = seqid
                diffNmax = max(diffNmax, ndiff - Nmax[i])
        if stop:
            break
        for kk in range(K):
            if inkk[kk]:
                continue
            k = order[kk]
            if keep[k] == 0:
                continue
            if keep[k] == 2:
                inkk[kk] = 2
                continue
            if seqid >= 100:
                in_k[k] = inkk[kk] = 1
                continue
            seqidk = max(seqid1, int(idmaxwin[first[k]:last[k] + 1].max())
                         if last[k] >= first[k] else seqid1)
            if seqid == seqid_prev[k]:
                continue
            seqid_prev[k] = seqid
            diff_min_frac = 0.9999 - 0.01 * seqidk
            accepted = True
            for jj in range(kk):
                if not inkk[jj]:
                    continue
                j = order[jj]
                first_kj = max(first[k], first[j])
                last_kj = min(last[k], last[j])
                cov_kj = last_kj - first_kj + 1
                diff_suff = int(diff_min_frac * min(nres[k], cov_kj) + 0.999)
                # SIMD-block-extended scan (AVX2: 32-byte blocks)
                b0 = (first_kj // block) * block
                b1 = (last_kj // block + 1) * block
                cov_kj += (first_kj - b0) + (b1 - (last_kj + 1))
                xk = X[k, b0:min(b1, L)]
                xj = X[j, b0:min(b1, L)]
                if b1 > L:  # past-the-end bytes are GAP in the reference buffers
                    pad = np.full(b1 - L, _GAP_I, dtype=np.int64)
                    xk = np.concatenate([xk, pad])
                    xj = np.concatenate([xj, pad])
                no_aa = (xk >= N_AA) | (xj >= N_AA)
                neq = (~no_aa) & (xk != xj)
                # per-block early exit like the reference's `diff < diff_suff`
                nblocks = (b1 - b0) // block
                diff = 0
                covs = cov_kj
                for bi in range(nblocks):
                    if diff >= diff_suff:
                        break
                    s = slice(bi * block, (bi + 1) * block)
                    covs -= int(no_aa[s].sum())
                    diff += int(neq[s].sum())
                if diff < diff_suff and diff <= diff_min_frac * covs and covs > 0:
                    accepted = False
                    break
            if accepted:
                in_k[k] = inkk[kk] = 1
                N[first[k]:last[k] + 1] += 1
        seqid_step = max(1, min(5, diffNmax // max(diffNmax_prev - diffNmax + 1, 1)
                                * seqid_step // 2))
        seqid += seqid_step
    keep_out = in_k.copy()
    keep_out[0] = 1
    return keep_out > 0


def compute_pssm_probs(msa: np.ndarray, p_back: np.ndarray,
                       pseudo_counts: np.ndarray,
                       pca: float = PCA, pcb: float = PCB,
                       wg: bool = False) -> np.ndarray:
    """MSA [K, L] -> per-position probabilities [L, 20]."""
    K, L = msa.shape
    valid = msa != GAP
    counted = valid & (msa < N_AA)
    w = _henikoff_weights(msa)

    if not wg:
        match, neff = _context_specific_weights(msa, w, p_back)
        g = match @ pseudo_counts[:N_AA, :N_AA].T
        tau = np.minimum(1.0, pca / (1.0 + neff / pcb))[:, None]
        return (1.0 - tau) * match + tau * g

    # match weights (computeMatchWeights), normalized with background fallback
    match = np.zeros((L, N_AA))
    for pos in range(L):
        sel = counted[:, pos]
        np.add.at(match[pos], msa[sel, pos], w[sel])
        s = match[pos].sum()
        if s > 0:
            match[pos] /= s
        else:
            match[pos] = p_back[:N_AA] / p_back[:N_AA].sum()

    # Neff (computeNeff_M)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.where(match > 1e-10, match * np.log2(match, where=match > 0), 0.0).sum(axis=1)
    neff_hmm = float(np.exp2(ent).mean())
    nlim = max(10.0, neff_hmm + 1.0)
    scale = np.log2((nlim - neff_hmm) / (nlim - 1.0))
    w_m = valid.astype(np.float64).T @ w - 1.0 / K
    neff = np.where(w_m < 0, 1.0, nlim - (nlim - 1.0) * np.exp2(scale * w_m))

    # substitution pseudocounts (preparePseudoCounts/computePseudoCounts)
    # pseudo_counts[a, b] = P(a|b): g[pos, a] = sum_b R[a, b] * match[pos, b]
    g = match @ pseudo_counts[:N_AA, :N_AA].T
    tau = np.minimum(1.0, pca / (1.0 + neff / pcb))[:, None]
    return (1.0 - tau) * match + tau * g


def probs_to_scores(probs: np.ndarray, p_back: np.ndarray,
                    bit_factor: float) -> np.ndarray:
    """[L, 20] probabilities -> int32 [21, L] profile (row = target letter),
    X row 0, at the given bit scale (computeLogPSSM semantics)."""
    with np.errstate(divide="ignore"):
        logodds = np.log2(np.maximum(probs, 1e-12) / p_back[None, :N_AA])
    scaled = bit_factor * logodds
    scores = np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int32)
    out = np.zeros((21, probs.shape[0]), dtype=np.int32)
    out[:N_AA] = scores.T
    return out


@dataclass
class ProfileEntry:
    key: int
    prob_aa: np.ndarray     # [L, 20]
    prob_ss: np.ndarray     # [L, 20]
    consensus_aa: np.ndarray
    consensus_ss: np.ndarray
    name: str = ""


E_PROFILE = 0.1  # --e-profile default (result2profile.cpp:33)


def result2profile(qdb: StructDB, tdb: StructDB,
                   results: Dict[int, List[AlnResult]],
                   e_profile: float = None,
                   filter_msa: bool = True,
                   wg: bool = False,
                   same_db: Optional[bool] = None) -> Dict[int, ProfileEntry]:
    """Build AA+3Di profiles for every query from its alignment results
    (reference: lib/mmseqs/src/util/result2profile.cpp:180-265 run once per
    track by data/result2structprofile.sh; hits enter the MSA only below
    --e-profile, the same-DB self hit is skipped, the MSA is
    redundancy-filtered, then context-specific weighting + pseudocounts).

    The two tracks use DIFFERENT parameters (result2structprofile.cpp:
    24-44): AA — pca 1.1 / pcb 4.1, e-profile 0.001; 3Di — pca 1.4 /
    pcb 1.5, e-profile 0.1 (when --e-profile is unset), no profile
    masking, no composition-bias correction on the stored bytes.
    An explicit e_profile overrides BOTH tracks (--e-profile wasSet)."""
    mb = blosum62()
    m3 = mat3di()
    sub_aa = blosum62(2.0, -0.2).scores
    sub_ss = mat3di(2.0, -0.2).scores
    if same_db is None:
        same_db = qdb.path == tdb.path
    q_idx = qdb.key_to_index()
    t_idx = tdb.key_to_index()
    out = {}
    e_aa = e_profile if e_profile is not None else 0.001
    e_ss = e_profile if e_profile is not None else E_PROFILE
    for qkey, rs in results.items():
        qi = q_idx[int(qkey)]
        rs = [r for r in rs if r.backtrace
              and not (same_db and int(r.db_key) == int(qkey))]
        rs_aa = [r for r in rs if r.evalue < e_aa]
        rs_ss = [r for r in rs if r.evalue < e_ss]
        t_aa = [np.asarray(tdb.get_aa(t_idx[r.db_key])) for r in rs_aa]
        t_ss = [np.asarray(tdb.get_ss(t_idx[r.db_key])) for r in rs_ss]
        msa_aa = _build_msa(np.asarray(qdb.get_aa(qi)), rs_aa, t_aa)
        msa_ss = _build_msa(np.asarray(qdb.get_ss(qi)), rs_ss, t_ss)
        if filter_msa:
            msa_aa = msa_aa[msa_filter(msa_aa, sub_aa)]
            msa_ss = msa_ss[msa_filter(msa_ss, sub_ss)]
        prob_aa = compute_pssm_probs(msa_aa, mb.p_back, mb.pseudo_counts, wg=wg)
        prob_ss = compute_pssm_probs(msa_ss, m3.p_back, m3.pseudo_counts,
                                     pca=1.4, pcb=1.5, wg=wg)
        out[int(qkey)] = ProfileEntry(
            key=int(qkey), prob_aa=prob_aa, prob_ss=prob_ss,
            consensus_aa=np.asarray(qdb.get_aa(qi)).copy(),
            consensus_ss=np.asarray(qdb.get_ss(qi)).copy(),
            name=qdb.names[qi])
    return out


def pssm_store_bytes(probs: np.ndarray, p_back: np.ndarray,
                     comp_bias_correction: bool = True) -> np.ndarray:
    """probs [L,20] -> the int8 PSSM bytes the reference stores: bit factor
    8 log-odds (PSSMCalculator::computeLogPSSM :259-272), then the windowed
    global composition-bias correction applied in place
    (SubstitutionMatrix::calcGlobalAaBiasCorrection :205-243,
    result2profile.cpp:275-277)."""
    with np.errstate(divide="ignore"):
        v = (np.float32(8.0) * np.log2(probs / p_back[None, :N_AA])).astype(np.float32)
    b = np.where(v < 0, v - 0.5, v + 0.5)
    b = np.clip(b.astype(np.float32), -128, 127).astype(np.int32)
    if not comp_bias_correction:
        return b
    L = probs.shape[0]
    w = 40
    p_null = (b.astype(np.float32) @ p_back[:N_AA].astype(np.float32)).astype(np.float32)
    # the reference corrects IN PLACE: row i's window mixes already-corrected
    # rows j<i with uncorrected rows j>i; p_null stays from the originals
    work = b.copy()
    for i in range(L):
        lo = max(0, i - w // 2)
        hi = min(L, i + w // 2)
        wl = hi - lo
        aa_sum = (work[lo:hi].sum(axis=0) - work[i]
                  - (p_null[lo:hi].sum() - p_null[i])).astype(np.float32)
        work[i] = (work[i] - aa_sum / np.float32(wl)).astype(np.int32)
    return work


def pssm_display_scores(probs: np.ndarray, p_back: np.ndarray,
                        comp_bias_correction: bool = True) -> np.ndarray:
    """The integers profile2pssm prints: stored bytes integer-divided by 4
    on read-in (Sequence::mapProfile :332-336)."""
    b = pssm_store_bytes(probs, p_back, comp_bias_correction)
    return (np.sign(b) * (np.abs(b) // 4)).astype(np.int32)  # C trunc division


def save_profile_db(profiles: Dict[int, ProfileEntry], path: str):
    os.makedirs(path, exist_ok=True)
    keys = sorted(profiles)
    np.savez_compressed(
        os.path.join(path, "profiles.npz"),
        keys=np.asarray(keys, dtype=np.int64),
        names=np.asarray([profiles[k].name for k in keys]),
        **{f"paa_{k}": profiles[k].prob_aa for k in keys},
        **{f"pss_{k}": profiles[k].prob_ss for k in keys},
        **{f"caa_{k}": profiles[k].consensus_aa for k in keys},
        **{f"css_{k}": profiles[k].consensus_ss for k in keys})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"kind": "profile", "n_entries": len(keys)}, f)


def is_profile_db(path: str) -> bool:
    m = os.path.join(path, "manifest.json")
    if not os.path.isfile(m):
        return False
    try:
        return json.load(open(m)).get("kind") == "profile"
    except Exception:
        return False


def load_profile_db(path: str) -> Dict[int, ProfileEntry]:
    data = np.load(os.path.join(path, "profiles.npz"))
    names = data["names"] if "names" in data else None
    out = {}
    for i, k in enumerate(data["keys"]):
        k = int(k)
        out[k] = ProfileEntry(key=k, prob_aa=data[f"paa_{k}"],
                              prob_ss=data[f"pss_{k}"],
                              consensus_aa=data[f"caa_{k}"],
                              consensus_ss=data[f"css_{k}"],
                              name=str(names[i]) if names is not None else f"profile_{k}")
    return out


class ProfileQueryDB:
    """Minimal StructDB surface over profile-DB consensus sequences, so the
    alignment stage and convertalis can treat a profile DB as the query side
    (the reference profile search drives Alignment.cpp with the profile's
    stored query sequence; no C-alpha payload, so TM/LDDT gates are off)."""

    def __init__(self, profiles: Dict[int, ProfileEntry]):
        self._keys = sorted(profiles)
        self._p = [profiles[k] for k in self._keys]
        self.keys = np.asarray(self._keys, dtype=np.int64)
        self.names = [p.name or f"profile_{p.key}" for p in self._p]
        self.headers = list(self.names)
        self.ca = None
        self.path = "<profile-db>"
        self.size = len(self._keys)

    def entry_len(self, i: int) -> int:
        return len(self._p[i].consensus_aa)

    def lengths(self) -> np.ndarray:
        return np.asarray([self.entry_len(i) for i in range(self.size)])

    def get_aa(self, i: int) -> np.ndarray:
        return self._p[i].consensus_aa

    def get_ss(self, i: int) -> np.ndarray:
        return self._p[i].consensus_ss

    def get_aa_str(self, i: int) -> str:
        from ..ops.matrices import ALPHABET
        return "".join(ALPHABET[c] for c in self._p[i].consensus_aa)

    def get_ca(self, i: int):
        raise ValueError("profile DB has no C-alpha data")

    def key_to_index(self):
        return {int(k): i for i, k in enumerate(self._keys)}


class PSSMQueryProfile:
    """QueryProfile-compatible wrapper around per-position PSSM scores —
    reversal flips the profile columns (the reference's profile search has
    no composition bias; StructureSmithWaterman isProfileSearch path)."""

    def __init__(self, q_aa, q_ss, prof_aa, prof_ss,
                 gap_open: int = 10, gap_extend: int = 1):
        self.q_aa = np.asarray(q_aa, dtype=np.int8)
        self.q_ss = np.asarray(q_ss, dtype=np.int8)
        self.L = len(self.q_aa)
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.bias_aa = np.zeros(self.L, dtype=np.int8)
        self.bias_ss = np.zeros(self.L, dtype=np.int8)
        self.prof_aa = prof_aa
        self.prof_ss = prof_ss

    def reversed(self) -> "PSSMQueryProfile":
        return PSSMQueryProfile(self.q_aa[::-1].copy(), self.q_ss[::-1].copy(),
                                self.prof_aa[:, ::-1].copy(),
                                self.prof_ss[:, ::-1].copy(),
                                self.gap_open, self.gap_extend)

    flipped = reversed

    def padded(self, lq_pad: int):
        from ..ops.matrices import ALPHA_SIZE
        from ..ops.sw import NEG_INF
        pa = np.full((ALPHA_SIZE, lq_pad), NEG_INF // 4, dtype=np.int32)
        ps = np.full((ALPHA_SIZE, lq_pad), NEG_INF // 4, dtype=np.int32)
        pa[:, : self.L] = self.prof_aa
        ps[:, : self.L] = self.prof_ss
        return pa, ps


def _alignment_scale(stored: np.ndarray) -> np.ndarray:
    """Stored int8 profile bytes [L, 20] -> the alignment profile the
    reference's Sequence::mapProfile derives (:334): stored / 4 with C
    truncation toward zero, X row 0; int32 [21, L]."""
    out = np.zeros((21, stored.shape[0]), dtype=np.int32)
    out[:N_AA] = np.trunc(stored.astype(np.float64) / 4.0).astype(np.int32).T
    return out


def profile_query(entry: ProfileEntry, gap_open: int = 10,
                  gap_extend: int = 1) -> PSSMQueryProfile:
    """Search profiles at the reference's profile-alignment scale: the
    STORED bytes (bit factor 8; AA with global comp-bias, SS without —
    result2structprofile.cpp:24-44) divided by 4 with C truncation
    (Sequence::mapProfile:334) — NOT a fresh rounding at the sequence
    scales 1.4/2.1, whose double-rounding drifted scores vs the binary."""
    mb = blosum62()
    m3 = mat3di()
    return PSSMQueryProfile(
        entry.consensus_aa, entry.consensus_ss,
        _alignment_scale(pssm_store_bytes(entry.prob_aa, mb.p_back,
                                          comp_bias_correction=True)),
        _alignment_scale(pssm_store_bytes(entry.prob_ss, m3.p_back,
                                          comp_bias_correction=False)),
        gap_open, gap_extend)

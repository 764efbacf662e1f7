"""TM-score of a given alignment (Kabsch superposition + iterative search).

Re-derivation of the reference's approximate TM-score path used for gating
and structure-bit scoring (reference: src/commons/TMaligner.cpp:50-104
computeAppoximateTMscore; lib/tmalign/TMalign.cpp:25-47 parameter_set4search,
:394-547 TMscore8_search_standard, :76-143 score_fun8,
:1366-1426 standard_TMscore). The algorithm is the published TM-score search:
superpose on fragments of the alignment (lengths L, L/2, ..., >=4, stride 40),
iteratively re-superpose on the <d subset (<=20 iterations), score with
sum 1/(1+(d_i/d0)^2) over pairs closer than score_d8.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TMResult:
    tmscore: float
    rmsd: float
    u: np.ndarray  # [3,3]
    t: np.ndarray  # [3]


def normalization(mode: int, aln_len: int, q_len: int, t_len: int) -> int:
    """reference: TMaligner::normalization (LocalParameters.h tmScoreThrMode):
    0=alignment, 1=query, 2=target, 3=min(q,t)."""
    if mode == 0:
        return aln_len
    if mode == 1:
        return q_len
    if mode == 2:
        return t_len
    return min(q_len, t_len)


def parameter_set4search(norm_len: int):
    """reference: lib/tmalign/TMalign.cpp:25-47."""
    lnorm = float(norm_len)
    if lnorm <= 19:
        d0 = 0.168
    else:
        d0 = 1.24 * (lnorm - 15.0) ** (1.0 / 3.0) - 1.8
    d0_min = d0 + 0.8
    d0 = d0_min
    d0_search = min(8.0, max(4.5, d0))
    score_d8 = 1.5 * lnorm ** 0.3 + 3.5
    return d0_min, lnorm, score_d8, d0, d0_search


def kabsch(x: np.ndarray, y: np.ndarray):
    """Least-squares superposition rotating x onto y: returns (u, t, rmsd) with
    y ~ x @ u.T + t (matching the reference's do_rotation convention
    xt[i] = t + u @ x[i])."""
    n = len(x)
    xc = x.mean(axis=0)
    yc = y.mean(axis=0)
    x0 = x - xc
    y0 = y - yc
    cov = x0.T @ y0
    v, s, wt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(v @ wt))
    diag = np.array([1.0, 1.0, d])
    u = (v * diag) @ wt  # rotation applied as x @ u
    e0 = (x0 ** 2).sum() + (y0 ** 2).sum()
    rms2 = max(0.0, e0 - 2.0 * (s[0] + s[1] + d * s[2]))
    rmsd = np.sqrt(rms2 / n)
    ut = u.T
    t = yc - xc @ u
    return ut, t, rmsd  # y ≈ (ut @ x.T).T + t


def _rotate(x, u, t):
    return x @ u.T + t


def score_fun8(xt: np.ndarray, y: np.ndarray, d: float, score_d8: float, d0: float):
    """reference: TMalign.cpp:76-143. Returns (subset_idx, score_sum)."""
    di = ((xt - y) ** 2).sum(axis=1)
    n_ali = len(di)
    score_sum = float((di < score_d8 * score_d8).astype(np.float64)
                      @ (1.0 / (1.0 + di / (d0 * d0))))
    d_tmp2 = d * d
    inc = 0
    while True:
        cut = di < d_tmp2
        if cut.sum() >= 3 or n_ali <= 3:
            break
        inc += 1
        dinc = d + inc * 0.5
        d_tmp2 = dinc * dinc
    return np.nonzero(cut)[0], score_sum


def tmscore8_search_standard(xtm: np.ndarray, ytm: np.ndarray,
                             simplify_step: int, local_d0_search: float,
                             score_d8: float, d0: float):
    """reference: TMalign.cpp:394-547. xtm/ytm: aligned coordinate pairs
    [L_ali, 3]. Returns (best raw score sum / Lali, u, t).

    Delegates to the native engine (tmscore8_search with lnorm = L_ali and
    n_it = 20 is exactly the standard variant); numpy fallback below."""
    from .. import native
    res = native.tm_search8(np.asarray(xtm, dtype=np.float64),
                            np.asarray(ytm, dtype=np.float64),
                            simplify_step, local_d0_search, score_d8, d0,
                            float(len(xtm)), n_it=20)
    if res is not None:
        return res
    l_ali = len(xtm)
    l_ini_min = min(4, l_ali)
    l_ini = []
    for i in range(5):
        lf = int(l_ali / (2.0 ** i))
        if lf <= l_ini_min:
            l_ini.append(l_ini_min)
            break
        l_ini.append(lf)
    else:
        l_ini.append(l_ini_min)

    score_max = -1.0
    u0 = np.eye(3)
    t0 = np.zeros(3)
    for l_frag in l_ini:
        il_max = l_ali - l_frag
        i = 0
        while True:
            frag = slice(i, i + l_frag)
            u, t, _ = kabsch(xtm[frag], ytm[frag])
            xt = _rotate(xtm, u, t)
            d = local_d0_search - 1.0
            cut, score = score_fun8(xt, ytm, d, score_d8, d0)
            score /= l_ali
            if score > score_max:
                score_max = score
                u0, t0 = u, t
            d = local_d0_search + 1.0
            for _ in range(20):
                u, t, _ = kabsch(xtm[cut], ytm[cut])
                xt = _rotate(xtm, u, t)
                new_cut, score = score_fun8(xt, ytm, d, score_d8, d0)
                score /= l_ali
                if score > score_max:
                    score_max = score
                    u0, t0 = u, t
                if len(new_cut) == len(cut) and (new_cut == cut).all():
                    break
                cut = new_cut
            if i < il_max:
                i = min(i + simplify_step, il_max)
            else:
                break
    return score_max, u0, t0


def compute_tm_score(q_ca: np.ndarray, t_ca: np.ndarray,
                     q_start: int, t_start: int, backtrace: str,
                     normalization_len: int) -> TMResult:
    """Approximate TM-score of a fixed alignment
    (reference: TMaligner.cpp:50-104). q_ca/t_ca: [L, 3] float32."""
    from .lddt import backtrace_indices
    q_idx, t_idx = backtrace_indices(backtrace, q_start, t_start)
    # x = target, y = query (TMaligner.cpp:74-81 invmap convention)
    xtm = np.asarray(t_ca[t_idx], dtype=np.float64)
    ytm = np.asarray(q_ca[q_idx], dtype=np.float64)
    n_al = len(xtm)
    if n_al == 0:
        return TMResult(0.0, 0.0, np.eye(3), np.zeros(3))

    from .. import native
    res = native.tm_score_aligned(xtm, ytm, normalization_len)
    if res is not None:
        tm, rmsd, u, t = res
        return TMResult(float(tm), float(rmsd), u, t)

    d0_min, lnorm, score_d8, d0, d0_search = parameter_set4search(normalization_len)

    # standard_TMscore (TMalign.cpp:1366-1426)
    if lnorm > 21:
        d0_std = 1.24 * (lnorm - 15.0) ** (1.0 / 3.0) - 1.8
    else:
        d0_std = 0.5
    d0_std = max(d0_std, 0.5)
    u_all, t_all, rmsd0 = kabsch(xtm, ytm)
    tm1, _, _ = tmscore8_search_standard(xtm, ytm, 40, d0_std, score_d8, d0_std)
    tm1 = tm1 * n_al / lnorm

    # detailed_search_standard (TMalign.cpp:589-624) with search params
    tm2, u, t = tmscore8_search_standard(xtm, ytm, 40, d0_search, score_d8, d0)
    tm2 = tm2 * n_al / lnorm

    tm = max(tm1, tm2)
    return TMResult(float(tm), float(rmsd0), u, t)

"""Full TM-align: structure alignment from coordinates alone.

Re-derivation of the reference's vectorized TM-align
(reference: lib/tmalign/TMalign.cpp TMalign_main:1429-1814,
src/commons/TMaligner.cpp TMaligner::align:232-328):

1. initial alignments — gapless threading (get_initial:770-828), secondary-
   structure NW (make_sec:845-934, get_initial_ss:937-972), local fragment
   superposition (get_initial5:975-1029), ss+superposition rescoring
   (get_initial_ssplus:1033-1091), fragment gapless threading
   (get_initial_fgt:1155-1270)
2. each seeded alignment is scored with the TM-score search engine
   (detailed_search:568-624, TMscore8_search:225-395) and refined by
   iterative NW over rotated-distance scores (DP_iter:1276-1360)
3. final TM-scores normalized by query and by target length

The NW is the reference's affine Needleman-Wunsch over float32 scores with
its exact boundary conditions (negative boundaries clamp to FLT_MIN, i.e.
effectively-free end gaps; lib/tmalign/affineneedlemanwunsch.cpp:343-370)
and tie-breaking (diagonal > query-gap > target-gap on H ties; gap
extension wins open ties). Implemented as a numpy anti-diagonal wavefront —
float32 per-cell arithmetic is order-independent, so results match the
striped SIMD original.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .tmscore import kabsch

FLT_MIN = np.float32(1.1754943508222875e-38)


# ---------------------------------------------------------------------------
# secondary structure assignment (TMalign.cpp:845-934)

def make_sec(ca: np.ndarray) -> np.ndarray:
    """1=coil, 2=helix, 3=turn, 4=strand from CA i-2..i+2 distances."""
    L = len(ca)
    sec = np.ones(L, dtype=np.int8)
    if L < 5:
        return sec
    x = ca.astype(np.float32)

    def d(a, b):
        return np.sqrt(((x[a] - x[b]) ** 2).sum(axis=-1))

    i = np.arange(2, L - 2)
    d13 = d(i - 2, i)
    d14 = d(i - 2, i + 1)
    d15 = d(i - 2, i + 2)
    d24 = d(i - 1, i + 1)
    d25 = d(i - 1, i + 2)
    d35 = d(i, i + 2)
    helix = ((np.abs(d15 - 6.37) < 2.1) & (np.abs(d14 - 5.18) < 2.1)
             & (np.abs(d25 - 5.18) < 2.1) & (np.abs(d13 - 5.45) < 2.1)
             & (np.abs(d24 - 5.45) < 2.1) & (np.abs(d35 - 5.45) < 2.1))
    strand = ((np.abs(d15 - 13) < 1.42) & (np.abs(d14 - 10.4) < 1.42)
              & (np.abs(d25 - 10.4) < 1.42) & (np.abs(d13 - 6.1) < 1.42)
              & (np.abs(d24 - 6.1) < 1.42) & (np.abs(d35 - 6.1) < 1.42))
    turn = d15 < 8
    s = np.ones(L - 4, dtype=np.int8)
    s[turn] = 3
    s[strand] = 4
    s[helix] = 2
    sec[2:L - 2] = s
    return sec


# ---------------------------------------------------------------------------
# affine NW over a float32 score matrix (wavefront Gotoh)

def nw_gotoh(score: np.ndarray, gap_open: float, gap_extend: float) -> np.ndarray:
    """Global affine NW maximizing sum of score[i, j] (i over query y,
    j over target x). Returns y2x: for each query row the aligned target
    column or -1. Boundary H/E values clamp at FLT_MIN (the reference's
    positive-epsilon floor), H ties prefer diagonal then target-gap (F)
    then query-gap (E); E/F open only on strict improvement."""
    ylen, xlen = score.shape
    open_ = np.float32(gap_open)
    ext = np.float32(gap_extend)
    score = score.astype(np.float32)

    def clamp(v):
        return np.maximum(v, FLT_MIN).astype(np.float32)

    # H[i][j], i: -1..ylen-1 (rows), j: -1..xlen-1
    H_prev = clamp(-open_ - ext * np.arange(-1, ylen, dtype=np.float32))
    H_prev[0] = np.float32(0.0)  # H(-1,-1)
    E_col = clamp(H_prev[1:] - open_)  # E(i, j=0) seeds from column init
    H_trace = np.zeros((ylen, xlen), dtype=np.int8)   # 0 diag, 1 F, 2 E
    E_trace = np.zeros((ylen, xlen), dtype=np.int8)   # 0 open, 1 extend
    F_trace = np.zeros((ylen, xlen), dtype=np.int8)

    boundary = clamp(-open_ - ext * np.arange(-1, xlen, dtype=np.float32))
    boundary[0] = np.float32(0.0)

    for j in range(xlen):
        H_col = np.empty(ylen + 1, dtype=np.float32)
        H_col[0] = boundary[j + 1]
        # E(i,j) = max(H(i,j-1)-open, E(i,j-1)-ext); 1 = extend wins ties
        e_from_open = H_prev[1:] - open_
        e_ext = E_col - ext
        E_new = np.maximum(e_from_open, e_ext)
        E_trace[:, j] = np.where(e_from_open > e_ext, 0, 1)
        # diagonal candidates
        diag = H_prev[:-1] + score[:, j]
        # F must be computed sequentially down the column
        f = FLT_MIN
        for i in range(ylen):
            f_open = H_col[i] - open_
            f_ext = f - ext
            if f_open > f_ext:
                f = f_open
                F_trace[i, j] = 0
            else:
                f = f_ext
                F_trace[i, j] = 1
            h = diag[i]
            tr = 0
            if E_new[i] > h:
                h = E_new[i]
                tr = 2
            if f > h:
                h = f
                tr = 1
            elif f == h and tr == 2:
                tr = 1  # F beats E on ties (DIAG > DEL(F) > INS(E))
            if diag[i] == h:
                tr = 0
            H_col[i + 1] = h
            H_trace[i, j] = tr
        H_prev = H_col
        E_col = E_new

    # backtrace from (ylen-1, xlen-1)
    y2x = np.full(ylen, -1, dtype=np.int64)
    i, j = ylen - 1, xlen - 1
    state = 0  # 0 = H, 1 = F, 2 = E
    while i >= 0 and j >= 0:
        if state == 0:
            tr = H_trace[i, j]
            if tr == 0:
                y2x[i] = j
                i -= 1
                j -= 1
            else:
                state = tr
        elif state == 1:  # F: consume query row i (gap in target)
            tr = F_trace[i, j]
            i -= 1
            state = 0 if tr == 0 else 1
        else:  # E: consume target column j (gap in query)
            tr = E_trace[i, j]
            j -= 1
            state = 0 if tr == 0 else 2
    return y2x


def _nw_gotoh_fast(score: np.ndarray, gap_open: float, gap_extend: float) -> np.ndarray:
    """Anti-diagonal-vectorized version of nw_gotoh (identical float32
    results — per-cell arithmetic has no cross-cell reassociation).
    Delegates to the native C implementation when available (bit-identical
    float32 semantics)."""
    from .. import native
    y2x_native = native.nw_gotoh_f32(score, gap_open, gap_extend)
    if y2x_native is not None:
        return y2x_native
    ylen, xlen = score.shape
    open_ = np.float32(gap_open)
    ext = np.float32(gap_extend)
    score = score.astype(np.float32)
    NEG = np.float32(-3.0e38)

    def clamp(v):
        return np.maximum(v, FLT_MIN).astype(np.float32)

    # H[i+1, j+1] etc. full matrices (float32); fine up to ~4k x 4k
    H = np.empty((ylen + 1, xlen + 1), dtype=np.float32)
    E = np.full((ylen + 1, xlen + 1), NEG, dtype=np.float32)
    F = np.full((ylen + 1, xlen + 1), NEG, dtype=np.float32)
    H[0, 0] = 0.0
    H[1:, 0] = clamp(-open_ - ext * np.arange(0, ylen, dtype=np.float32))
    H[0, 1:] = clamp(-open_ - ext * np.arange(0, xlen, dtype=np.float32))
    E[1:, 0] = clamp(H[1:, 0] - open_)
    F[0, 1:] = FLT_MIN

    H_trace = np.zeros((ylen, xlen), dtype=np.int8)
    E_trace = np.zeros((ylen, xlen), dtype=np.int8)
    F_trace = np.zeros((ylen, xlen), dtype=np.int8)

    for d in range(ylen + xlen - 1):
        i0 = max(0, d - xlen + 1)
        i1 = min(ylen - 1, d)
        ii = np.arange(i0, i1 + 1)
        jj = d - ii
        e_open = H[ii + 1, jj] - open_
        e_ext = E[ii + 1, jj] - ext
        e = np.maximum(e_open, e_ext)
        E[ii + 1, jj + 1] = e
        E_trace[ii, jj] = np.where(e_open > e_ext, 0, 1)
        f_open = H[ii, jj + 1] - open_
        f_ext = F[ii, jj + 1] - ext
        f = np.maximum(f_open, f_ext)
        F[ii + 1, jj + 1] = f
        F_trace[ii, jj] = np.where(f_open > f_ext, 0, 1)
        diag = H[ii, jj] + score[ii, jj]
        h = np.maximum(np.maximum(diag, e), f)
        H[ii + 1, jj + 1] = h
        # priority: diag > F > E
        tr = np.where(h == diag, 0, np.where(h == f, 1, 2)).astype(np.int8)
        H_trace[ii, jj] = tr

    y2x = np.full(ylen, -1, dtype=np.int64)
    i, j = ylen - 1, xlen - 1
    state = 0
    while i >= 0 and j >= 0:
        if state == 0:
            tr = H_trace[i, j]
            if tr == 0:
                y2x[i] = j
                i -= 1
                j -= 1
            else:
                state = tr
        elif state == 1:
            tr = F_trace[i, j]
            i -= 1
            state = 0 if tr == 0 else 1
        else:
            tr = E_trace[i, j]
            j -= 1
            state = 0 if tr == 0 else 2
    return y2x


def nw_xyz(x: np.ndarray, y: np.ndarray, t: np.ndarray, u: np.ndarray,
           d02: float, gap_open: float,
           sec_bonus: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
    """NW over score(i,j) = 1/(1 + |u x_j + t - y_i|^2 / d02)
    (+0.5 ss-match bonus for the ssplus variant). Returns y2x.
    Delegates score build + NW to the native library when available."""
    from .. import native
    secy_b, secx_b = sec_bonus if sec_bonus is not None else (None, None)
    y2x = native.nw_xyz(x, y, u, t, d02, gap_open, secx=secx_b, secy=secy_b)
    if y2x is not None:
        return y2x
    xt = (x.astype(np.float32) @ np.asarray(u, dtype=np.float32).T
          + np.asarray(t, dtype=np.float32))
    diff = y.astype(np.float32)[:, None, :] - xt[None, :, :]
    dij = (diff * diff).sum(axis=-1, dtype=np.float32)
    score = np.float32(1.0) / (np.float32(1.0) + dij / np.float32(d02))
    if sec_bonus is not None:
        secy, secx = sec_bonus
        score = score + np.where(secy[:, None] == secx[None, :],
                                 np.float32(0.5), np.float32(0.0))
    return _nw_gotoh_fast(score, gap_open, 0.0)


def nw_ss(secx: np.ndarray, secy: np.ndarray) -> np.ndarray:
    """Secondary-structure NW: +1 for identical states, gap open 1.0."""
    score = (secy[:, None] == secx[None, :]).astype(np.float32)
    return _nw_gotoh_fast(score, 1.0, 0.0)


# ---------------------------------------------------------------------------
# TM-score search engine (float32 coordinates, float64 accumulation like the
# reference's double score sums)

def parameter_set4search(xlen: int, ylen: int):
    """TMalign.cpp parameter_set4search(xlen, ylen, ...)."""
    d0_min = 0.5
    lnorm = min(xlen, ylen)
    if lnorm <= 19:
        d0 = 0.168
    else:
        d0 = 1.24 * (lnorm - 15) ** (1.0 / 3.0) - 1.8
    d0_min = d0 + 0.8
    d0 = d0_min
    d0_search = min(8.0, max(4.5, d0))
    score_d8 = 1.5 * lnorm ** 0.3 + 3.5
    dcu0 = 4.25
    return d0_min, lnorm, score_d8, d0, d0_search, dcu0


def parameter_set4final(length: float):
    d0_min = 0.5
    lnorm = length
    if lnorm <= 21:
        d0 = 0.5
    else:
        d0 = 1.24 * (lnorm - 15) ** (1.0 / 3.0) - 1.8
    d0 = max(d0, d0_min)
    d0_search = min(8.0, max(4.5, d0))
    return d0_min, lnorm, d0, d0_search


def _score_fun8(xt, ytm, d, lnorm, score_d8, d0):
    """score_fun8 (TMalign.cpp:76-143): d8-cutoff TM sum / lnorm and the
    <d subset (threshold relaxed until >=3 pairs)."""
    di = ((xt - ytm) ** 2).sum(axis=1)
    n_ali = len(di)
    score = float(((di < score_d8 * score_d8) * (1.0 / (1.0 + di / (d0 * d0)))).sum()) / lnorm
    d_tmp2 = d * d
    inc = 0
    while True:
        cut = di < d_tmp2
        if cut.sum() >= 3 or n_ali <= 3:
            break
        inc += 1
        dinc = d + inc * 0.5
        d_tmp2 = dinc * dinc
    return np.nonzero(cut)[0], score


def tmscore8_search(xtm: np.ndarray, ytm: np.ndarray, simplify_step: int,
                    local_d0_search: float, lnorm: float, score_d8: float,
                    d0: float):
    """TMscore8_search (TMalign.cpp:225-395): n_it=10, up to 6 fragment
    lengths, score normalized by lnorm. Returns (score, u, t)."""
    from .. import native
    res = native.tm_search8f(np.asarray(xtm, dtype=np.float32),
                             np.asarray(ytm, dtype=np.float32),
                             simplify_step, local_d0_search, score_d8, d0,
                             lnorm, n_it=10)
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
            xt = xtm @ u.T + t
            d = local_d0_search - 1.0
            cut, score = _score_fun8(xt, ytm, d, lnorm, score_d8, d0)
            if score > score_max:
                score_max = score
                u0, t0 = u, t
            d = local_d0_search + 1.0
            for _ in range(10):
                prev_cut = cut
                u, t, _ = kabsch(xtm[cut], ytm[cut])
                xt = xtm @ u.T + t
                cut, score = _score_fun8(xt, ytm, d, lnorm, score_d8, d0)
                if score > score_max:
                    score_max = score
                    u0, t0 = u, t
                if len(cut) == len(prev_cut) and (cut == prev_cut).all():
                    break
            if i < il_max:
                i = min(i + simplify_step, il_max)
            else:
                break
    return score_max, u0, t0


def _gather(x, y, y2x):
    mask = y2x >= 0
    return x[y2x[mask]], y[mask]


def detailed_search(x: np.ndarray, y: np.ndarray, y2x: np.ndarray,
                    simplify_step: int, local_d0_search: float, lnorm: float,
                    score_d8: float, d0: float):
    xtm, ytm = _gather(x, y, y2x)
    if len(xtm) == 0:
        return -1.0, np.eye(3), np.zeros(3)
    return tmscore8_search(xtm, ytm, simplify_step, local_d0_search,
                           lnorm, score_d8, d0)


def get_score_fast(x, y, y2x, d0, d0_search):
    """get_score_fast (TMalign.cpp:627-768): three Kabsch iterations.
    Delegates to the native implementation (same kabsch_d used by
    tm_search8); numpy fallback below."""
    xtm, ytm = _gather(x, y, y2x)
    k = len(xtm)
    if k < 3:
        return -1.0
    from .. import native
    s = native.score_fast(np.asarray(xtm, dtype=np.float32),
                          np.asarray(ytm, dtype=np.float32), d0, d0_search)
    if s is not None:
        return s
    u, t, _ = kabsch(xtm, ytm)
    d02 = d0 * d0
    d002 = d0_search * d0_search
    xt = xtm @ u.T + t
    dis = ((xt - ytm) ** 2).sum(axis=1)
    tmscore = float((1.0 / (1.0 + dis / d02)).sum())

    d002t = d002
    while True:
        sub = dis <= d002t
        if sub.sum() >= 3 or k <= 3:
            break
        d002t += 0.5
    if sub.sum() != k:
        u, t, _ = kabsch(xtm[sub], ytm[sub])
        xt = xtm @ u.T + t
        dis = ((xt - ytm) ** 2).sum(axis=1)
        tm1 = float((1.0 / (1.0 + dis / d02)).sum())
        d002t = d002 + 1.0
        while True:
            sub = dis <= d002t
            if sub.sum() >= 3 or k <= 3:
                break
            d002t += 0.5
        u, t, _ = kabsch(xtm[sub], ytm[sub])
        xt = xtm @ u.T + t
        dis = ((xt - ytm) ** 2).sum(axis=1)
        tm2 = float((1.0 / (1.0 + dis / d02)).sum())
    else:
        tm1 = tm2 = tmscore
    return max(tmscore, tm1, tm2)


# ---------------------------------------------------------------------------
# initial alignments

def _best_candidate(x, y, y2x_all, d0, d0_search):
    """Score a [n, ylen] candidate batch (one native call when available)
    and return the row the sequential `>=`-update loop would keep: the
    LAST row attaining the max."""
    if len(y2x_all) == 0:
        return None
    from .. import native
    scores = native.score_fast_batch(x, y, y2x_all, d0, d0_search)
    if scores is None:
        scores = np.array([get_score_fast(x, y, y2x, d0, d0_search)
                           for y2x in y2x_all])
    best = np.nonzero(scores == scores.max())[0][-1]
    return y2x_all[best]


def get_initial(x, y, d0, d0_search, fast_opt):
    xlen, ylen = len(x), len(y)
    min_len = min(xlen, ylen)
    min_ali = max(5, min_len // 2)
    n1 = -ylen + min_ali
    n2 = xlen - min_ali
    step = 5 if fast_opt else 1
    jj = np.arange(ylen)
    ks = np.arange(n1, n2 + 1, step)
    ii = jj[None, :] + ks[:, None]
    y2x_all = np.where((ii >= 0) & (ii < xlen), ii, -1)
    return _best_candidate(x, y, y2x_all, d0, d0_search)


def get_initial5(x, y, d0, d0_search, d0_min, fast_opt):
    d01 = max(d0 + 1.5, d0_min)
    d02 = d01 * d01
    xlen, ylen = len(x), len(y)
    aL = min(xlen, ylen)

    def jump(L):
        if L > 250:
            n = 45
        elif L > 200:
            n = 35
        elif L > 150:
            n = 25
        else:
            n = 15
        return min(n, L // 3)

    n_jump1, n_jump2 = jump(xlen), jump(ylen)
    n_frag = [min(20, aL // 3), min(100, aL // 2)]
    if fast_opt:
        n_jump1 *= 5
        n_jump2 *= 5
    best = None
    gl_max = 0.0
    for nf in n_frag:
        m1 = xlen - nf + 1
        m2 = ylen - nf + 1
        for i in range(0, m1, max(1, n_jump1)):
            for j in range(0, m2, max(1, n_jump2)):
                u, t, _ = kabsch(x[i:i + nf], y[j:j + nf])
                y2x = nw_xyz(x, y, t, u, d02, 0.0)
                gl = get_score_fast(x, y, y2x, d0, d0_search)
                if gl > gl_max:
                    gl_max = gl
                    best = y2x
    return best


def get_initial_ssplus(x, y, secx, secy, y2x_prev, d0, d0_min):
    d01 = max(d0 + 1.5, d0_min)
    d02 = d01 * d01
    xs, ys = _gather(x, y, y2x_prev)
    if len(xs) < 3:
        return y2x_prev
    u, t, _ = kabsch(xs, ys)
    return nw_xyz(x, y, t, u, d02, 1.0, sec_bonus=(secy, secx))


def find_max_frag(x, dcu0, fast_opt):
    L = len(x)
    fra_min = 8 if fast_opt else 4
    r_min = min(L // 3, fra_min)
    dcu_cut = dcu0 * dcu0
    inc = 0
    while True:
        lfr_max = 0
        start_max = 0
        end_max = 0
        j = 1
        start = 0
        for i in range(1, L):
            if ((x[i - 1] - x[i]) ** 2).sum() < dcu_cut:
                j += 1
                if i == L - 1:
                    if j > lfr_max:
                        lfr_max = j
                        start_max = start
                        end_max = i
                    j = 1
            else:
                if j > lfr_max:
                    lfr_max = j
                    start_max = start
                    end_max = i - 1
                j = 1
                start = i
        if lfr_max >= r_min:
            return start_max, end_max
        inc += 1
        dinc = (1.1 ** inc) * dcu0
        dcu_cut = dinc * dinc


def get_initial_fgt(x, y, d0, d0_search, dcu0, fast_opt):
    xlen, ylen = len(x), len(y)
    fra_min = 8 if fast_opt else 4
    fra_min1 = fra_min - 1
    xstart, xend = find_max_frag(x, dcu0, fast_opt)
    ystart, yend = find_max_frag(y, dcu0, fast_opt)
    Lx = xend - xstart + 1
    Ly = yend - ystart + 1
    L_fr = min(Lx, Ly)
    if Lx < Ly or (Lx == Ly and xlen <= ylen):
        ifr = list(range(xstart, xstart + L_fr))
        x_side = True
    else:
        ifr = list(range(ystart, ystart + L_fr))
        x_side = False

    L0 = min(xlen, ylen)
    if L_fr == L0:
        n1 = int(L0 * 0.1)
        n2 = int(L0 * 0.89)
        ifr = ifr[n1:n2 + 1]
        L_fr = len(ifr)

    ifr = np.asarray(ifr)
    if x_side:
        L1 = L_fr
        min_ali = max(fra_min1, int(min(L1, ylen) / 2.5))
        n1, n2 = -ylen + min_ali, L1 - min_ali
        jj = np.arange(ylen)
        ks = np.arange(n1, n2 + 1, 3 if fast_opt else 1)
        ii = jj[None, :] + ks[:, None]
        valid = (ii >= 0) & (ii < L1)
        y2x_all = np.where(valid, ifr[np.clip(ii, 0, L1 - 1)], -1)
    else:
        L2 = L_fr
        min_ali = max(fra_min1, int(min(xlen, L2) / 2.5))
        n1, n2 = -L2 + min_ali, xlen - min_ali
        ks = np.arange(n1, n2 + 1)
        y2x_all = np.full((len(ks), ylen), -1, dtype=np.int64)
        jj = np.arange(L2)
        for r, k in enumerate(ks):
            i = jj + k
            valid = (i >= 0) & (i < xlen)
            y2x_all[r, ifr[jj[valid]]] = i[valid]
    return _best_candidate(x, y, y2x_all, d0, d0_search)


def dp_iter(x, y, y2x_seed, g1, g2, iteration_max, local_d0_search, lnorm,
            d0, score_d8):
    """DP_iter (TMalign.cpp:1276-1360). Delegates to the native
    implementation (same NW / TMscore8 engines); numpy fallback below."""
    from .. import native
    res = native.dp_iter(x, y, y2x_seed, g1, g2, iteration_max,
                         local_d0_search, lnorm, d0, score_d8)
    if res is not None:
        return res
    d02 = d0 * d0
    gap_opens = [-0.6, 0.0]
    best_score = -1.0
    best = None
    xtm, ytm = _gather(x, y, y2x_seed)
    _, u, t = tmscore8_search(xtm, ytm, 40, local_d0_search, lnorm,
                              score_d8, d0)
    for g in range(g1, g2):
        tmscore_old = 0.0
        uu, tt = u, t
        for it in range(iteration_max):
            y2x = nw_xyz(x, y, tt, uu, d02, -gap_opens[g])
            xs, ys = _gather(x, y, y2x)
            if len(xs) == 0:
                break
            tm, uu, tt = tmscore8_search(xs, ys, 40, local_d0_search, lnorm,
                                         score_d8, d0)
            if tm > best_score:
                best_score = tm
                best = y2x
            if it > 0 and abs(tmscore_old - tm) < 0.000001:
                break
            tmscore_old = tm
    return best_score, best


# ---------------------------------------------------------------------------
# main entry

@dataclass
class TMalignResult:
    tm_query: float    # TM normalized by query length (TM1/TM_0)
    tm_target: float   # TM normalized by target length (TM2)
    rmsd: float
    n_ali8: int
    backtrace: str     # freeshift M/I/D from first to last match
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    identical: int
    u: np.ndarray
    t: np.ndarray


def tmalign(q_ca: np.ndarray, t_ca: np.ndarray,
            q_seq: Optional[np.ndarray] = None,
            t_seq: Optional[np.ndarray] = None,
            fast: bool = True) -> Optional[TMalignResult]:
    """TM-align target (x) onto query (y). Convention follows
    TMaligner::align: x = target structure, y = query; the reference module
    default is --tmalign-fast 1 (LocalParameters.cpp:344)."""
    y = np.asarray(q_ca, dtype=np.float32)
    x = np.asarray(t_ca, dtype=np.float32)
    xlen, ylen = len(x), len(y)
    if xlen <= 5 or ylen <= 5:
        return None

    # one-call native path (same engines orchestrated in C; python below
    # is the reference/fallback implementation)
    from .. import native
    nf = native.tmalign_full(x, y, fast)
    if nf == "none":
        return None
    if nf is not None:
        tm1, tm2, rmsd0, n_ali8, u0, t0, sel = nf
        m1, m2 = [], []
        for j in range(ylen):
            if sel[j] >= 0:
                m1.append(int(sel[j]))
                m2.append(j)
        bt = []
        ident = 0
        pi, pj = m1[0], m2[0]
        for i, j in zip(m1, m2):
            bt.extend("D" * (i - pi))
            bt.extend("I" * (j - pj))
            bt.append("M")
            if q_seq is not None and t_seq is not None and q_seq[j] == t_seq[i]:
                ident += 1
            pi, pj = i + 1, j + 1
        return TMalignResult(
            tm_query=float(tm1), tm_target=float(tm2), rmsd=float(rmsd0),
            n_ali8=n_ali8, backtrace="".join(bt),
            q_start=int(m2[0]), q_end=int(m2[-1]),
            t_start=int(m1[0]), t_end=int(m1[-1]),
            identical=ident, u=u0, t=t0)

    d0_min, lnorm, score_d8, d0, d0_search, dcu0 = parameter_set4search(xlen, ylen)
    local_d0_search = d0_search
    ddcc = 0.1 if lnorm <= 40 else 0.4
    simplify_step = 40

    secx = make_sec(x)
    secy = make_sec(y)

    tm_max = -1.0
    invmap0 = None

    def consider(y2x, run_dp, iters, g1=0):
        nonlocal tm_max, invmap0
        if y2x is None:
            return
        tm, _, _ = detailed_search(x, y, y2x, simplify_step, local_d0_search,
                                   lnorm, score_d8, d0)
        if tm > tm_max:
            tm_max = tm
            invmap0 = y2x
        if run_dp(tm):
            tm2, y2x2 = dp_iter(x, y, y2x, g1, 2, iters, local_d0_search,
                                lnorm, d0, score_d8)
            if tm2 > tm_max and y2x2 is not None:
                tm_max = tm2
                invmap0 = y2x2

    # 1) gapless threading
    consider(get_initial(x, y, d0, d0_search, fast),
             lambda tm: True, 2 if fast else 30)
    # 2) secondary structure
    consider(nw_ss(secx, secy), lambda tm: tm > tm_max * 0.2, 2 if fast else 30)
    # 3) local superposition
    consider(get_initial5(x, y, d0, d0_search, d0_min, fast),
             lambda tm: tm > tm_max * ddcc, 2)
    # 4) ss + superposition
    if invmap0 is not None:
        consider(get_initial_ssplus(x, y, secx, secy, invmap0, d0, d0_min),
                 lambda tm: tm > tm_max * ddcc, 2 if fast else 30)
    # 5) fragment gapless threading (DP only with the zero gap-open,
    #    TMalign.cpp:1588 g1=1)
    consider(get_initial_fgt(x, y, d0, d0_search, dcu0, fast),
             lambda tm: tm > tm_max * ddcc, 2, g1=1)

    if invmap0 is None or (invmap0 < 0).all():
        return None

    # detailed search (standard engine, n_it=20) for the final rotation
    # (TMalign_main:1624-1628 detailed_search_standard)
    from .tmscore import tmscore8_search_standard
    step = 40 if fast else 1
    xtm, ytm = _gather(x, y, invmap0)
    _, u, t = tmscore8_search_standard(xtm, ytm, step, local_d0_search,
                                       score_d8, d0)
    # select pairs with d < score_d8
    xt_all = x @ u.T + t
    m1, m2 = [], []
    for j in range(ylen):
        i = int(invmap0[j])
        if i < 0:
            continue
        d = np.sqrt(((xt_all[i] - y[j]) ** 2).sum())
        if d <= score_d8:
            m1.append(i)
            m2.append(j)
    n_ali8 = len(m1)
    if n_ali8 == 0:
        return None
    xtm8 = x[m1]
    ytm8 = y[m2]
    _, _, rmsd0 = kabsch(xtm8, ytm8)

    # final TM normalized by query then target length
    _, lnorm_q, d0_q, d0s_q = parameter_set4final(float(ylen))
    tm1, u0, t0 = tmscore8_search(xtm8, ytm8, 1, d0s_q, lnorm_q, score_d8, d0_q)
    _, lnorm_t, d0_t, d0s_t = parameter_set4final(float(xlen))
    tm2, _, _ = tmscore8_search(xtm8, ytm8, 1, d0s_t, lnorm_t, score_d8, d0_t)

    # freeshift backtrace between first and last matched pair
    # (TMaligner::align:292-328)
    bt = []
    ident = 0
    q_start, t_start = m2[0], m1[0]
    pi, pj = m1[0], m2[0]
    for i, j in zip(m1, m2):
        # gaps between consecutive matches
        bt.extend("D" * (i - pi))
        bt.extend("I" * (j - pj))
        bt.append("M")
        if q_seq is not None and t_seq is not None and q_seq[j] == t_seq[i]:
            ident += 1
        pi, pj = i + 1, j + 1
    return TMalignResult(
        tm_query=float(tm1), tm_target=float(tm2), rmsd=float(rmsd0),
        n_ali8=n_ali8, backtrace="".join(bt),
        q_start=int(q_start), q_end=int(m2[-1]),
        t_start=int(t_start), t_end=int(m1[-1]),
        identical=ident, u=u0, t=t0)

"""Plain numpy TM-score and LDDT of a fixed alignment, in float64 (TM) and
float32 (LDDT) as foldseek computes them for its structure bits.

TM-score (TMaligner::computeAppoximateTMscore over TM-align's
TMscore8_search): the alignment's C-alpha pairs are superposed on fragments
of L, L/2, L/4, ... (at least 4) columns, starting every 40 columns; each
superposition is refined up to 20 times on the pairs closer than a growing
cutoff; the score is sum 1 / (1 + (d/d0)^2) over pairs closer than
score_d8, over the normalisation length. Two searches, with the standard d0
and with the search d0, and the larger result is taken.

LDDT (LDDT.cpp): for each aligned query residue, the fraction of its
preserved distances (|d_q - d_t| under 0.5, 1, 2, 4 A) to the other aligned
residues within 15 A in the query, over the count of all query residues
within 15 A of it; the mean over aligned residues that have neighbours.
"""
from __future__ import annotations

import numpy as np


def aligned_pairs(backtrace: str, q_start: int, t_start: int):
    """(query, target) residue indices of the M columns of a backtrace."""
    qi, ti, out_q, out_t = q_start, t_start, [], []
    for op in backtrace:
        if op == "M":
            out_q.append(qi)
            out_t.append(ti)
            qi += 1
            ti += 1
        elif op == "I":
            qi += 1
        else:
            ti += 1
    return np.asarray(out_q, dtype=np.int64), np.asarray(out_t, dtype=np.int64)


def _superpose(x, y):
    """Rotation u and translation t with y ~ x @ u.T + t (least squares)."""
    xc, yc = x.mean(axis=0), y.mean(axis=0)
    a, s, bt = np.linalg.svd((x - xc).T @ (y - yc))
    d = np.sign(np.linalg.det(a @ bt))
    r = (a * np.array([1.0, 1.0, d])) @ bt
    return r.T, yc - xc @ r


def _score(xt, y, d_cut, score_d8, d0):
    di = ((xt - y) ** 2).sum(axis=1)
    total = float(np.sum(np.where(di < score_d8 * score_d8,
                                  1.0 / (1.0 + di / (d0 * d0)), 0.0)))
    d2, inc = d_cut * d_cut, 0
    while True:
        cut = di < d2
        if cut.sum() >= 3 or len(di) <= 3:
            return np.nonzero(cut)[0], total
        inc += 1
        d2 = (d_cut + 0.5 * inc) ** 2


def _search(x, y, d0_search, score_d8, d0):
    n = len(x)
    lens, min_len = [], min(4, n)
    for k in range(5):
        f = int(n / (2.0 ** k))
        if f <= min_len:
            lens.append(min_len)
            break
        lens.append(f)
    else:
        lens.append(min_len)
    best = -1.0
    for frag in lens:
        last, i = n - frag, 0
        while True:
            u, t = _superpose(x[i:i + frag], y[i:i + frag])
            cut, s = _score(x @ u.T + t, y, d0_search - 1.0, score_d8, d0)
            best = max(best, s / n)
            for _ in range(20):
                u, t = _superpose(x[cut], y[cut])
                new, s = _score(x @ u.T + t, y, d0_search + 1.0, score_d8, d0)
                best = max(best, s / n)
                if len(new) == len(cut) and (new == cut).all():
                    break
                cut = new
            if i >= last:
                break
            i = min(i + 40, last)
    return best


def tm_score(q_ca, t_ca, q_start, t_start, backtrace, norm_len) -> float:
    qi, ti = aligned_pairs(backtrace, q_start, t_start)
    if len(qi) == 0:
        return 0.0
    x = np.asarray(t_ca, dtype=np.float64)[ti]
    y = np.asarray(q_ca, dtype=np.float64)[qi]
    ln = float(norm_len)
    d0 = 0.168 if ln <= 19 else 1.24 * (ln - 15.0) ** (1.0 / 3.0) - 1.8
    d0 += 0.8
    d0_search = min(8.0, max(4.5, d0))
    score_d8 = 1.5 * ln ** 0.3 + 3.5
    d0_std = max(1.24 * (ln - 15.0) ** (1.0 / 3.0) - 1.8 if ln > 21 else 0.5,
                 0.5)
    tm1 = _search(x, y, d0_std, score_d8, d0_std) * len(x) / ln
    tm2 = _search(x, y, d0_search, score_d8, d0) * len(x) / ln
    return max(tm1, tm2)


def lddt(q_ca, t_ca, q_start, t_start, backtrace) -> float:
    qi, ti = aligned_pairs(backtrace, q_start, t_start)
    if len(qi) == 0:
        return 0.0
    q = np.asarray(q_ca, dtype=np.float32)
    t = np.asarray(t_ca, dtype=np.float32)
    dq_all = np.sqrt(((q[qi, None, :] - q[None, :, :]) ** 2).sum(-1))
    near_all = dq_all < 15.0
    near_all[np.arange(len(qi)), qi] = False
    degree = near_all.sum(axis=1)
    dq = dq_all[:, qi]
    near = near_all[:, qi]
    dt = np.sqrt(((t[ti, None, :] - t[None, ti, :]) ** 2).sum(-1))
    dl = np.abs(dq - dt)
    kept = (0.25 * ((dl < 0.5).astype(np.float32) + (dl < 1.0) + (dl < 2.0)
                    + (dl < 4.0)))
    col = np.where(near, kept, 0.0).sum(axis=1)
    ok = degree > 0
    if not ok.any():
        return 0.0
    return float((col[ok] / degree[ok]).astype(np.float32).sum() / ok.sum())

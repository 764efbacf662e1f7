"""LoLalign: structure alignment optimizing the Local-distance Log-odds
score (reference: src/strucclustutils/LoLAlign.{h,cpp}).

Flow (LoLAlign::align): seed 10 start anchors from a global forward-backward
posterior over the 3Di(+AA) score matrix, keep the 3 best-scoring seeds, and
iteratively grow each: rescore the unanchored region with the LoL score (a
tiny 2->3->1 ReLU net over |d_q - d_t| distance differences and log sequence
offsets against the current anchor set), run forward-backward over the gap
segments, and anchor every pair whose posterior clears the threshold. The
final score is the anchor-set LoL+3Di score normalized by the query
self-score and (qLen*tLen)^0.25.

The per-anchor LoL rescoring vectorizes over whole gap blocks (numpy);
the posteriors run through ops.fwbw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .fwbw import fwbw_posterior

# hardcoded LoL net weights + 3Di matrix (LoLAlign.h:120-165)
W1 = np.array([[-1.3584513e-04, 7.6149112e-01, -8.1348085e-01],
               [9.9329501e-01, 5.7029408e-01, 6.0702705e-01]], dtype=np.float32)
B1 = np.array([0.7043129, 0.374659, 0.39905924], dtype=np.float32)
W2 = np.array([-0.776632, 0.61055756, 0.5823986], dtype=np.float32)
B2 = np.float32(0.38799961)

MAT3DI_LOL = np.array([
    [10, -1, 1, 7, 6, 2, 2, -4, 1, -1, -6, -2, -1, 4, -1, -5, -1, -5, 3, 2],
    [-1, 7, -4, -5, -3, -2, -1, -10, -10, 1, -11, 1, -2, 2, 1, 1, -6, 1, -5, -5],
    [1, -4, 0, -3, -1, 0, 1, -4, -5, -6, -5, -4, -3, -3, -2, -6, -2, -6, -2, -2],
    [7, -5, -3, 15, 3, -2, 1, -8, -5, -4, -12, -5, -5, 1, -3, -7, -5, -10, -2, 3],
    [6, -3, -1, 3, 10, 1, 1, -2, 4, -1, -5, -3, -2, 4, -2, -6, 0, -6, 7, 0],
    [2, -2, 0, -2, 1, 10, 7, 3, -3, -5, 3, 1, -2, -1, 5, -1, 7, -5, -1, 3],
    [2, -1, 1, 1, 1, 7, 10, 0, -4, -4, -1, 3, -1, 0, 4, -1, 3, -4, -1, 8],
    [-4, -10, -4, -8, -2, 3, 0, 11, -1, -10, 11, -5, -6, -3, 0, -7, 9, -11, -2, -3],
    [1, -10, -5, -5, 4, -3, -4, -1, 13, -9, -4, -9, -7, -2, -6, -12, -2, -13, 9, -3],
    [-1, 1, -6, -4, -1, -5, -4, -10, -9, 6, -13, -2, -3, 3, -2, -3, -7, 0, -6, -6],
    [-6, -11, -5, -12, -5, 3, -1, 11, -4, -13, 15, -6, -8, -7, -1, -8, 7, -14, -2, -4],
    [-2, 1, -4, -5, -3, 1, 3, -5, -9, -2, -6, 8, -1, -1, 4, 4, -2, 0, -6, -1],
    [-1, -2, -3, -5, -2, -2, -1, -6, -7, -3, -8, -1, 1, -1, -1, -3, -4, -2, -5, -5],
    [4, 2, -3, 1, 4, -1, 0, -3, -2, 3, -7, -1, -1, 7, 0, -2, -3, -1, 1, -1],
    [-1, 1, -2, -3, -2, 5, 4, 0, -6, -2, -1, 4, -1, 0, 8, 4, 3, -1, -3, 1],
    [-5, 1, -6, -7, -6, -1, -1, -7, -12, -3, -8, 4, -3, -2, 4, 6, -4, 0, -9, -5],
    [-1, -6, -2, -5, 0, 7, 3, 9, -2, -7, 7, -2, -4, -3, 3, -4, 11, -8, -2, 0],
    [-5, 1, -6, -10, -6, -5, -4, -11, -13, 0, -14, 0, -2, -1, -1, 0, -8, 2, -9, -9],
    [3, -5, -2, -2, 7, -1, -1, -2, 9, -6, -2, -6, -5, 1, -3, -9, -2, -9, 11, -2],
    [2, -5, -2, 3, 0, 3, 8, -3, -3, -6, -4, -1, -5, -1, 1, -5, 0, -9, -2, 14],
], dtype=np.float32)

NUM_START_ANCHORS = 10
SEED_NUMBER = 3
START_ANCHOR_GO, START_ANCHOR_GE, START_ANCHOR_T = -6.0, -3.0, 2.0
LOL_GO, LOL_GE, LOL_T = -1.5, -0.0, 4.0
LOL_MIN_P = 0.7


def lol_nn(d_dist: np.ndarray, d_seq) -> np.ndarray:
    """The 2-input 3-hidden ReLU scorer; invalid entries (d_dist < 0)
    contribute 0 (lolScore, LoLAlign.cpp:845-905). Hidden units are summed
    without materializing the [..., 3] intermediate (hot path)."""
    d_dist = np.asarray(d_dist, dtype=np.float32)
    d_seq = np.broadcast_to(np.asarray(d_seq, dtype=np.float32), d_dist.shape)
    out = np.float32(B2[0] if np.ndim(B2) else B2) + np.zeros_like(d_dist)
    for h in range(3):
        out += np.float32(W2[h]) * np.maximum(
            0.0, d_seq * np.float32(W1[0, h]) + d_dist * np.float32(W1[1, h])
            + np.float32(B1[h])).astype(np.float32)
    return np.where(d_dist >= 0, out, 0.0).astype(np.float32)


def _dist_matrix(ca: np.ndarray, cutoff: bool) -> np.ndarray:
    from .. import native
    nd = native.dist_matrix(ca, cutoff)  # bit-identical
    if nd is not None:
        return nd
    d = np.sqrt(((ca[:, None, :] - ca[None, :, :]) ** 2).sum(-1)).astype(np.float32)
    if cutoff:
        d = np.where(d > 20.0, 0.0, d)
    return d


def _seq_dist(i, j):
    diff = np.asarray(i, dtype=np.float32) - np.asarray(j, dtype=np.float32)
    return np.copysign(1.0, diff) * np.log1p(np.abs(diff))


@dataclass
class LoLResult:
    score: float
    norm_score: float       # result.eval — the qq-normalized LoL score
    seq_id: float
    qcov: float
    tcov: float
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    backtrace: str


class LoLAligner:
    def __init__(self, multi_domain: bool = False, aa_factor: float = 0.0):
        self.multi_domain = multi_domain
        self.aa_factor = aa_factor

    def init_query(self, q_ca, q_aa, q_ss, sub_aa: np.ndarray):
        """sub_aa: integer AA substitution matrix at the chosen aa bit
        factor (0 for pure-LoL mode, matching easy-search --alignment-type 3)."""
        self.q_ca = np.asarray(q_ca, dtype=np.float32)
        self.q_aa = np.asarray(q_aa)
        self.q_ss = np.asarray(q_ss)
        self.sub_aa = np.asarray(sub_aa, dtype=np.float32)
        L = len(self.q_aa)
        self.qL = L
        self.start_anchor_len = 0 if L < 10 else 3
        self.dist_q = _dist_matrix(self.q_ca, cutoff=True)
        # query self score (initQuery:771-797) — note the reference reuses
        # lolScoreVec: it holds the per-residue 3Di+AA scores from
        # computeDiScore and the LoL loop ADDS onto them, so
        # qq = (diSum + lolSum) + 3*diSum
        ss = np.minimum(self.q_ss, 19)
        di_vec = (self.sub_aa[self.q_aa, self.q_aa] * 1.4
                  + MAT3DI_LOL[ss, ss] * 2.1).astype(np.float64)
        di_score = float(di_vec.sum())
        lol_vec = di_vec.copy()
        ii = np.arange(L)
        from .. import native
        sd_table = _seq_dist(np.arange(2 * L - 1) - (L - 1),
                             np.zeros(2 * L - 1))
        if not native.lol_init_query_vec(self.dist_q, sd_table, W1, B1, W2,
                                         B2, lol_vec):
            for i in range(L):
                valid = self.dist_q[i] > 0
                d_seq = _seq_dist(i, ii)
                lol_vec += lol_nn(np.where(valid, 0.0, -1.0),
                                  np.where(valid, d_seq, -1.0))
        qq = float(lol_vec.sum()) + 3.0 * di_score
        if not self.multi_domain:
            qq /= (L * L) ** 0.25
        self.qq_score = qq

    def _fwd_score_matrix(self, t_aa, t_ss):
        ssq = np.minimum(self.q_ss, 19)
        sst = np.minimum(np.asarray(t_ss), 19)
        return np.ascontiguousarray(
            (self.sub_aa[self.q_aa][:, t_aa] * np.float32(1.4)
             + MAT3DI_LOL[ssq][:, sst] * np.float32(2.1)).astype(np.float32))

    @staticmethod
    def _calc_gap(aq, at, gaps, q_len, t_len):
        """calcGap (LoLAlign.cpp:96-136): next unanchored block."""
        iq, it = gaps[1], gaps[3]
        while aq[iq] != 0 or at[it] != 0:
            if aq[iq] != 0 and at[it] != 0:
                iq += 1
                it += 1
            elif aq[iq] == 0:
                iq += 1
            else:
                it += 1
            if iq == q_len or it == t_len:
                gaps[0] = -1
                return gaps
        gaps[0], gaps[2] = iq, it
        while aq[iq] == 0 or at[it] == 0:
            if aq[iq] == 0 and at[it] == 0:
                iq += 1
                it += 1
            elif aq[iq] == 0:
                iq += 1
            else:
                it += 1
            if iq == q_len or it == t_len:
                iq, it = q_len, t_len
                break
        gaps[1], gaps[3] = iq, it
        return gaps

    def _lol_matrix_block(self, aq, at, gaps, dist_t, lol_m):
        """lolMatrix: add LoL contributions of every *new* anchor (state 2)
        to the unanchored block rows [g0,g1) x cols [g2,g3)."""
        g0, g1, g2, g3 = gaps
        anchors_q = np.nonzero(aq == 2)[0]
        anchors_t = np.nonzero(at == 2)[0]
        n = min(len(anchors_q), len(anchors_t))
        if n == 0 or g1 <= g0 or g3 <= g2:
            return
        from .. import native
        mm = native.lol_block(self.dist_q, dist_t, anchors_q[:n],
                              anchors_t[:n], g0, g1, g2, g3,
                              W1, B1, W2, float(B2), lol_m)
        if mm is not None:
            self._min_idx = min(self._min_idx, mm[0])
            self._max_idx = max(self._max_idx, mm[1])
            return
        rows = np.arange(g0, g1)
        for k in range(n):
            a_q, a_t = anchors_q[k], anchors_t[k]
            dq = self.dist_q[a_q, g0:g1]                      # [rows]
            valid = dq > 0
            if not valid.any():
                continue
            sel = rows[valid]
            self._min_idx = min(self._min_idx, int(sel.min()))
            self._max_idx = max(self._max_idx, int(sel.max()) + 1)
            d_seq = _seq_dist(a_q, sel)                       # [v]
            dd = np.abs(dq[valid][:, None] - dist_t[a_t, g2:g3][None, :])
            contrib = lol_nn(dd, d_seq[:, None])              # [v, cols]
            lol_m[sel[:, None], np.arange(g2, g3)[None, :]] += contrib

    def align(self, t_ca, t_aa, t_ss) -> Optional[LoLResult]:
        qL = self.qL
        t_aa = np.asarray(t_aa)
        t_ss = np.asarray(t_ss)
        tL = len(t_aa)
        if qL <= 5 or tL <= 5:
            return None
        sal = self.start_anchor_len
        self._min_idx, self._max_idx = qL, 0
        lol_m = self._fwd_score_matrix(t_aa, t_ss)
        self._lol_m0 = lol_m  # reused by _anchor_lol_score (native scorer)
        dist_t = _dist_matrix(np.asarray(t_ca, dtype=np.float32), cutoff=False)

        # one-call native orchestration (same seeding/grow/selection logic
        # compiled; the python below is the semantics reference/fallback)
        from .. import native
        nf = native.lolalign_full(
            lol_m, self.dist_q, dist_t, sal, self.multi_domain,
            W1, B1, W2, float(B2), START_ANCHOR_GO, START_ANCHOR_GE,
            START_ANCHOR_T, LOL_GO, LOL_GE, LOL_T, LOL_MIN_P,
            NUM_START_ANCHORS, SEED_NUMBER)
        if nf == "none":
            return None
        if nf is not None:
            return self._make_result(nf[0], nf[1], dist_t, t_aa, t_ss, tL)

        # ---- start anchors from the global posterior ----
        P, max_p = fwbw_posterior(lol_m, START_ANCHOR_GO, START_ANCHOR_GE,
                                  START_ANCHOR_T)
        P = P.copy()
        aq = np.zeros((NUM_START_ANCHORS, qL), dtype=np.int8)
        at = np.zeros((NUM_START_ANCHORS, tL), dtype=np.int8)
        anchor_len = np.zeros(NUM_START_ANCHORS, dtype=np.int64)
        seed_scores = np.zeros(NUM_START_ANCHORS, dtype=np.float64)
        for s in range(NUM_START_ANCHORS):
            sub = P[sal:qL - sal, sal:tL - sal]
            if sub.size == 0:
                break
            flat = int(np.argmax(sub))
            mi = flat // sub.shape[1] + sal
            mj = flat % sub.shape[1] + sal
            # seed score: LoL over the seed diagonal (align:215-247)
            start_row = mi - min(mi, mj)
            start_col = mj - min(mi, mj)
            diag_len = min(qL - start_row, tL - start_col)
            vec = lol_m[start_row + np.arange(diag_len),
                        start_col + np.arange(diag_len)].astype(np.float64).copy()
            for off in range(-sal, sal):
                dq = self.dist_q[mi + off, start_row:start_row + diag_len]
                valid = dq > 0
                dd = np.where(valid,
                              np.abs(dq - dist_t[mj + off, start_col:start_col + diag_len]),
                              -1.0)
                dsq = np.where(valid,
                               _seq_dist(mi + off, start_row + np.arange(diag_len)),
                               -1.0)
                vec += lol_nn(dd, dsq)
            # max subarray (Kadane)
            cur = best = vec[0]
            for v in vec[1:]:
                cur = max(v, cur + v)
                best = max(best, cur)
            seed_scores[s] = best
            # mark the seed band (alignStartAnchors)
            for off in range(-sal, sal + 1):
                i = mi + off
                j = mj + off
                aq[s, i] = 2
                at[s, j] = 2
                P[i, j] = 0.0
                lol_m[i, j] = 0.0
                anchor_len[s] += 1

        order = np.argsort(seed_scores, kind="stable")
        lol_m = self._fwd_score_matrix(t_aa, t_ss)  # reset for seeds

        # ---- grow each of the top seeds ----
        prob = np.zeros((qL, tL), dtype=np.float64)
        snapshots = []  # pre-extension anchor sets (multi-domain mode)
        for seed_iter in range(SEED_NUMBER):
            s = int(order[NUM_START_ANCHORS - seed_iter - 1])
            lol_work = np.zeros_like(lol_m)
            add_seq = False
            for iteration in range(1000):
                gaps = [0, 0, 0, 0]
                while gaps[1] < qL and gaps[3] < tL:
                    gaps = self._calc_gap(aq[s], at[s], gaps, qL, tL)
                    if gaps[0] == -1:
                        break
                    self._lol_matrix_block(aq[s], at[s], gaps, dist_t, lol_work)
                aq[s][aq[s] == 2] = 1
                at[s][at[s] == 2] = 1

                # forward-backward over the gap segments
                max_p_iter = 0.5 if iteration == 0 else LOL_MIN_P
                gaps = [self._min_idx, 0, 0, 0]
                while gaps[1] < self._max_idx and gaps[3] < tL:
                    gaps = self._calc_gap(aq[s], at[s], gaps, self._max_idx, tL)
                    if gaps[0] == -1:
                        break
                    block = lol_work[gaps[0]:gaps[1], gaps[2]:gaps[3]]
                    if block.size == 0:
                        continue
                    Pb, mp = fwbw_posterior(block, LOL_GO, LOL_GE, LOL_T)
                    max_p_iter = max(max_p_iter, mp)
                    prob[gaps[0]:gaps[1], gaps[2]:gaps[3]] = Pb

                # anchor qualifying pairs
                new_anchors = 0
                gaps = [self._min_idx, 0, 0, 0]
                while gaps[1] < self._max_idx and gaps[3] < tL:
                    gaps = self._calc_gap(aq[s], at[s], gaps, self._max_idx, tL)
                    if gaps[0] == -1:
                        break
                    for i in range(gaps[0], gaps[1]):
                        if aq[s, i] != 0:
                            continue
                        for j in range(gaps[2], gaps[3]):
                            if prob[i, j] > max_p_iter - 0.1 and at[s, j] == 0:
                                aq[s, i] = 2
                                at[s, j] = 2
                                anchor_len[s] += 1
                                new_anchors += 1
                                break
                if new_anchors == 0:
                    if self.multi_domain and not add_seq:
                        # multi-domain extension (align:281-322): snapshot
                        # the current anchors, reopen the full query range
                        # with a fresh 3Di+AA layer, keep growing
                        add_seq = True
                        snapshots.append((aq[s].copy(), at[s].copy()))
                        self._min_idx, self._max_idx = 0, qL
                        lol_work += self._fwd_score_matrix(t_aa, t_ss)
                        continue
                    break

        # ---- pick the best anchor set by total LoL score ----
        candidates = [(int(order[NUM_START_ANCHORS - k - 1]),) for k in range(SEED_NUMBER)]
        anchor_sets = [(aq[s], at[s]) for (s,) in candidates]
        anchor_sets += snapshots
        best_score = -np.inf
        best = None
        for a_q, a_t in anchor_sets:
            total = self._anchor_lol_score(a_q, a_t, dist_t, t_aa, t_ss)[0]
            if total > best_score:
                best_score = total
                best = (a_q, a_t)
        if best is None:
            return None
        return self._make_result(best[0], best[1], dist_t, t_aa, t_ss, tL)

    def _anchor_pairs(self, aq, at):
        fa_q = np.nonzero(aq != 0)[0]
        fa_t = np.nonzero(at != 0)[0]
        n = min(len(fa_q), len(fa_t))
        return fa_q[:n], fa_t[:n]

    def _anchor_lol_score(self, aq, at, dist_t, t_aa, t_ss):
        """Total LoL score of the anchor set (+ the per-anchor 3Di+AA base),
        plus the self-hit-normalized variant (align:430-470)."""
        from .. import native
        lol_m0 = getattr(self, "_lol_m0", None)
        if lol_m0 is None:
            lol_m0 = self._fwd_score_matrix(t_aa, t_ss)
        res = native.lol_anchor_score(aq, at, lol_m0, self.dist_q, dist_t,
                                      W1, B1, W2, float(B2))
        if res is not None:
            total, max_lol, norm_sh, fa_q, fa_t = res
            if len(fa_q) == 0:
                return -np.inf, 0.0, 0.0, fa_q, fa_t
            return total, max_lol, norm_sh, fa_q, fa_t
        fa_q, fa_t = self._anchor_pairs(aq, at)
        n = len(fa_q)
        if n == 0:
            return -np.inf, 0.0, 0.0, fa_q, fa_t
        ssq = np.minimum(self.q_ss[fa_q], 19)
        sst = np.minimum(np.asarray(t_ss)[fa_t], 19)
        di = (self.sub_aa[self.q_aa[fa_q], np.asarray(t_aa)[fa_t]] * 1.4
              + MAT3DI_LOL[ssq, sst] * 2.1).astype(np.float64)
        dq = self.dist_q[np.ix_(fa_q, fa_q)]
        dt = dist_t[np.ix_(fa_t, fa_t)]
        valid = dq > 0
        dd = np.where(valid, np.abs(dq - dt), -1.0)
        dsq = np.where(valid, _seq_dist(fa_q[:, None], fa_q[None, :]), -1.0)
        # buffer reuse like the reference: the per-anchor vector starts at
        # the 3Di+AA score (computeDiScore) and the LoL loop adds onto it
        lol_vec = di + lol_nn(dd, dsq).sum(axis=0)
        # self-hit variant (distance differences zero), zero-initialized
        dd_sh = np.where(valid, 0.0, -1.0)
        lol_sh = lol_nn(dd_sh, dsq).sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(lol_sh != 0, lol_vec / lol_sh, 0.0)
        norm_selfhit = float(np.nan_to_num(ratio).sum())
        max_lol = float(lol_vec[lol_sh != 0].sum())
        total_for_seed = float(lol_vec.sum())
        return total_for_seed, max_lol, norm_selfhit, fa_q, fa_t

    def _make_result(self, aq, at, dist_t, t_aa, t_ss, tL) -> Optional[LoLResult]:
        _, max_lol, norm_selfhit, fa_q, fa_t = self._anchor_lol_score(
            aq, at, dist_t, t_aa, t_ss)
        n = len(fa_q)
        if n == 0:
            return None
        ssq = np.minimum(self.q_ss[fa_q], 19)
        sst = np.minimum(np.asarray(t_ss)[fa_t], 19)
        di = float((self.sub_aa[self.q_aa[fa_q], np.asarray(t_aa)[fa_t]] * 1.4
                    + MAT3DI_LOL[ssq, sst] * 2.1).sum())
        seq_id = float((self.q_aa[fa_q] == np.asarray(t_aa)[fa_t]).mean())

        # result.score / result.eval (align:445-460)
        raw = (max_lol + 3.0 * di) * norm_selfhit / n
        if not self.multi_domain:
            score = raw / (self.qL * tL) ** 0.25
            norm = (raw / self.qq_score) / (self.qL * tL) ** 0.25
        else:
            score = raw
            norm = raw / self.qq_score

        # backtrace over the full anchor sets, trimmed to the first match
        bt = []
        qi = ti = 0
        matches = 0
        while matches < n:
            if aq[qi] != 0 and at[ti] != 0:
                bt.append("M")
                matches += 1
                qi += 1
                ti += 1
            elif at[ti] == 0:
                bt.append("D")
                ti += 1
            else:
                bt.append("I")
                qi += 1
        bt = "".join(bt)
        first_m = bt.find("M")
        q_start = bt[:first_m].count("I")
        t_start = bt[:first_m].count("D")
        bt = bt[first_m:]
        q_end = q_start + bt.count("M") + bt.count("I") - 1
        t_end = t_start + bt.count("M") + bt.count("D") - 1
        return LoLResult(
            score=score, norm_score=norm, seq_id=seq_id,
            qcov=n / self.qL, tcov=n / tL,
            q_start=q_start, q_end=q_end, t_start=t_start, t_end=t_end,
            backtrace=bt)

"""Query profiles and the plain Smith-Waterman score pass.

Counterpart of `foldseek_tpu/ops/sw.py`: `calc_comp_bias`, `QueryProfile`
and `sw_score_endpos_np` are that module's (numpy, shared semantics with the
reference's StructureSmithWaterman.cpp). `sw_score_endpos_torch` is the plain PyTorch
version of that module's XLA column scan (`sw_score_endpos`): one query
profile against a batch of padded targets. Its engine, `sw_scan_torch`,
scores pairs of (profile slot, target) and is also the plain version of the
CUDA kernel in `csrc/sw.cu` (see `ops/sw_kernels.py`).

Semantics, as in the reference:
  * gap of length l costs gap_open + (l-1) * gap_extend
  * per-cell score = prof_aa[t_aa][i] + prof_ss[t_ss][i]
  * E (gap in target) opens from h *before* F is applied (lazy F)
  * F[i] = max_{k<i}(h_noF[k] + k*ge) - (i-1)*ge - go
  * ties: target end = first column strictly improving the best score;
    query end = smallest query row attaining that column's max
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .matrices import ALPHA_SIZE, blosum62, mat3di

NEG_INF = -(2**30)


def calc_comp_bias(seq_num: np.ndarray, sub_mat: np.ndarray, p_back: np.ndarray,
                   scale: float) -> np.ndarray:
    """Windowed composition bias correction, float then rounded to int8 range
    (reference: lib/mmseqs/src/commons/SubstitutionMatrix.cpp:79-109 and the
    int8 rounding in StructureSmithWaterman.cpp:1567).

    Note the reference computes *both* the AA and the 3Di bias against the AA
    substitution matrix and AA background (ssw_init passes `m`=subMatAA for
    both, StructureSmithWaterman.cpp:1564-1574) — mirrored here by the caller.
    """
    N = len(seq_num)
    w = 40
    rows = sub_mat[seq_num].astype(np.int64)  # [N, 21]
    scores = rows[:, seq_num]  # [N, N] int scores
    # windowed sum via cumulative sums (exact: integer math)
    idx = np.arange(N)
    lo = np.maximum(0, idx - w // 2)
    hi = np.minimum(N, idx + w // 2)
    csum = np.zeros((N, N + 1), dtype=np.int64)
    np.cumsum(scores, axis=1, out=csum[:, 1:])
    win = csum[idx, hi] - csum[idx, lo] - scores[idx, idx]
    # float32 sequential accumulation identical to the reference loop
    # (float deltaS_i += double(pBack[a]) * float(short score))
    delta = (win.astype(np.float64) / (-1.0 * (hi - lo))).astype(np.float32)
    n_alpha = sub_mat.shape[0]
    for a in range(n_alpha):
        delta = (delta.astype(np.float64) + p_back[a] * rows[:, a].astype(np.float64)).astype(np.float32)
    out = np.float32(scale) * delta
    b = np.where(out < 0.0, out - 0.5, out + 0.5)
    return b.astype(np.int8)


class QueryProfile:
    """Per-query combined scoring profile for device + host use.

    prof[a_aa, a_ss, i] is too big; instead we keep two [21, Lq] tables that
    the kernel gathers per target column and adds — matching the reference's
    two-profile sum per cell (StructureSmithWaterman.cpp:1179).
    """

    def __init__(self, q_aa: np.ndarray, q_ss: np.ndarray,
                 comp_bias_correction: bool = True,
                 comp_bias_scale: float = 0.5,
                 gap_open: int = 10, gap_extend: int = 1,
                 with_aa: bool = True):
        # with_aa=False is 3Di-only alignment (--alignment-type 0): the
        # reference builds the AA matrix at bit factor 0.0 so every AA score
        # and its composition bias are zero (structurealign.cpp:264-265)
        m3 = mat3di()
        mb = blosum62()
        self.q_aa = np.asarray(q_aa, dtype=np.int8)
        self.q_ss = np.asarray(q_ss, dtype=np.int8)
        self.L = len(q_aa)
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self._bias_on = comp_bias_correction
        self._bias_scale = comp_bias_scale
        self._with_aa = with_aa
        if comp_bias_correction and with_aa:
            # both biases come from the AA matrix (ssw_init's `m` arg,
            # structurealign.cpp:344); at aa bit factor 0.0 that matrix is
            # all-zero, so 3Di-only mode has zero bias on both alphabets
            self.bias_aa = calc_comp_bias(self.q_aa, mb.scores, mb.p_back, 1.0)
            self.bias_ss = calc_comp_bias(self.q_ss, mb.scores, mb.p_back, comp_bias_scale)
        else:
            self.bias_aa = np.zeros(self.L, dtype=np.int8)
            self.bias_ss = np.zeros(self.L, dtype=np.int8)
        # [21, Lq] tables: row = target letter, col = query position
        aa_scores = mb.scores if with_aa else np.zeros_like(mb.scores)
        self.prof_aa = (aa_scores[:, self.q_aa].astype(np.int32)
                        + self.bias_aa[None, :].astype(np.int32))
        self.prof_ss = (m3.scores[:, self.q_ss].astype(np.int32)
                        + self.bias_ss[None, :].astype(np.int32))

    def reversed(self) -> "QueryProfile":
        """Profile of the reversed query. The reference reverses the sequence
        and recomputes the composition bias (structurealign.cpp:345-347); the
        [i-20, i+20) window is not mirror-symmetric, so the bias must be
        recomputed, not flipped."""
        rev = object.__new__(QueryProfile)
        rev.q_aa = self.q_aa[::-1].copy()
        rev.q_ss = self.q_ss[::-1].copy()
        rev.L = self.L
        rev.gap_open = self.gap_open
        rev.gap_extend = self.gap_extend
        mb = blosum62()
        has_bias = bool((self.bias_aa.any() or self.bias_ss.any() or self._bias_on)
                        and self._with_aa)
        if has_bias:
            rev.bias_aa = calc_comp_bias(rev.q_aa, mb.scores, mb.p_back, 1.0)
            rev.bias_ss = calc_comp_bias(rev.q_ss, mb.scores, mb.p_back, self._bias_scale)
        else:
            rev.bias_aa = np.zeros(self.L, dtype=np.int8)
            rev.bias_ss = np.zeros(self.L, dtype=np.int8)
        rev._bias_on = self._bias_on
        rev._bias_scale = self._bias_scale
        rev._with_aa = self._with_aa
        m3 = mat3di()
        aa_scores = mb.scores if self._with_aa else np.zeros_like(mb.scores)
        rev.prof_aa = (aa_scores[:, rev.q_aa].astype(np.int32)
                       + rev.bias_aa[None, :].astype(np.int32))
        rev.prof_ss = (m3.scores[:, rev.q_ss].astype(np.int32)
                       + rev.bias_ss[None, :].astype(np.int32))
        return rev

    def flipped(self) -> "QueryProfile":
        """Reverse-copied profile (sequence AND bias flipped) — this is what
        the reference uses for start-position recovery
        (StructureSmithWaterman.cpp:1703-1706 reverse_copy of the forward
        composition bias), unlike reversed() which recomputes the bias."""
        rev = object.__new__(QueryProfile)
        rev.q_aa = self.q_aa[::-1].copy()
        rev.q_ss = self.q_ss[::-1].copy()
        rev.L = self.L
        rev.gap_open = self.gap_open
        rev.gap_extend = self.gap_extend
        rev.bias_aa = self.bias_aa[::-1].copy()
        rev.bias_ss = self.bias_ss[::-1].copy()
        rev._bias_on = self._bias_on
        rev._bias_scale = self._bias_scale
        rev._with_aa = getattr(self, "_with_aa", True)
        rev.prof_aa = self.prof_aa[:, ::-1].copy()
        rev.prof_ss = self.prof_ss[:, ::-1].copy()
        return rev

    def padded(self, lq_pad: int) -> Tuple[np.ndarray, np.ndarray]:
        """[21, lq_pad] profiles, padding scores NEG_INF so padded query rows
        never participate."""
        pa = np.full((ALPHA_SIZE, lq_pad), NEG_INF // 4, dtype=np.int32)
        ps = np.full((ALPHA_SIZE, lq_pad), NEG_INF // 4, dtype=np.int32)
        pa[:, : self.L] = self.prof_aa
        ps[:, : self.L] = self.prof_ss
        return pa, ps



def sw_score_endpos_np(prof_aa, prof_ss, t_aa, t_ss,
                       gap_open=10, gap_extend=1, terminate=0, reverse_target=False):
    """Reference-exact scalar implementation (single target), used for start
    position recovery and unit testing. Mirrors sw_sse2_word semantics incl.
    the `terminate` early stop of the reverse pass
    (StructureSmithWaterman.cpp:1282 maxColumn[i] == terminate break)."""
    Lq = prof_aa.shape[1]
    Lt = len(t_aa)
    H = np.zeros(Lq, dtype=np.int64)
    E = np.full(Lq, -(2**31), dtype=np.int64)
    best = 0
    best_j = 0
    best_qend = Lq - 1
    qidx = np.arange(Lq)
    cols = range(Lt - 1, -1, -1) if reverse_target else range(Lt)
    for j in cols:
        s = prof_aa[t_aa[j]] + prof_ss[t_ss[j]]
        diag = np.empty_like(H)
        diag[0] = 0
        diag[1:] = H[:-1]
        h_noF = np.maximum(np.maximum(diag + s, E), 0)
        g = h_noF + qidx * gap_extend
        pmax = np.maximum.accumulate(g)
        F = np.empty_like(H)
        F[0] = -(2**31)
        F[1:] = pmax[:-1] - (qidx[1:] - 1) * gap_extend - gap_open
        H = np.maximum(h_noF, F)
        E = np.maximum(E - gap_extend, h_noF - gap_open)
        col_max = int(H.max())
        if col_max > best:
            best = col_max
            best_j = j
            best_qend = int(np.argmax(H == col_max))
        if terminate and col_max == terminate:
            break
    return best, best_qend, best_j


def sw_scan_torch(prof_aa: torch.Tensor, prof_ss: torch.Tensor,
                  slot_len: torch.Tensor, pair_slot: torch.Tensor,
                  t_aa: torch.Tensor, t_ss: torch.Tensor, t_len: torch.Tensor,
                  gap_open: int = 10, gap_extend: int = 1):
    """Affine SW score and end positions for P (slot, target) pairs.

    prof_aa, prof_ss: int32 [S, 21, Lm] slot profiles; rows >= slot_len[s]
      take no part in the column max (their value is free, they only feed
      later rows); slot_len: int [S], >= 1.
    pair_slot: int [P] slot of each pair; t_aa, t_ss: int [P, Lt] target
      letters (clamped to 0..20 like XLA's gather); t_len: int [P].
    Returns (score, q_end, t_end) int32 [P]; a pair that never scores
    above 0 keeps t_end 0 and q_end slot_len - 1.
    """
    dev = prof_aa.device
    S, _, Lm = prof_aa.shape
    P, Lt = t_aa.shape
    go, ge = int(gap_open), int(gap_extend)
    pair_slot = pair_slot.to(dev, torch.long)
    t_aa = t_aa.to(dev, torch.long).clamp(0, ALPHA_SIZE - 1)
    t_ss = t_ss.to(dev, torch.long).clamp(0, ALPHA_SIZE - 1)
    t_len = t_len.to(dev, torch.int32)
    L = slot_len.to(dev, torch.int32)[pair_slot]                  # [P]
    qpos = torch.arange(Lm, device=dev, dtype=torch.int32)
    row_ok = qpos[None, :] < L[:, None]                           # [P, Lm]
    big = torch.full((P, Lm), Lm, device=dev, dtype=torch.int32)
    neg_col = torch.full((P, 1), NEG_INF, device=dev, dtype=torch.int32)
    zero_col = torch.zeros((P, 1), device=dev, dtype=torch.int32)
    H = torch.zeros((P, Lm), device=dev, dtype=torch.int32)
    E = torch.full((P, Lm), NEG_INF, device=dev, dtype=torch.int32)
    best = torch.zeros(P, device=dev, dtype=torch.int32)
    best_j = torch.zeros(P, device=dev, dtype=torch.int32)
    best_q = L - 1
    for j in range(Lt):
        s = prof_aa[pair_slot, t_aa[:, j]] + prof_ss[pair_slot, t_ss[:, j]]
        diag = torch.cat([zero_col, H[:, :-1]], dim=1)
        h_nof = torch.clamp_min(torch.maximum(diag + s, E), 0)
        g = h_nof + qpos * ge
        pmax = torch.cummax(g, dim=1).values
        F = torch.cat([neg_col, pmax[:, :-1]], dim=1) - (qpos - 1) * ge - go
        H = torch.maximum(h_nof, F)
        E = torch.maximum(E - ge, h_nof - go)
        Hm = torch.where(row_ok, H, -1)
        col_max = Hm.max(dim=1).values
        col_max = torch.where(j < t_len, col_max, -1)
        improved = col_max > best
        col_q = torch.where(Hm == col_max[:, None], qpos, big).min(dim=1).values
        best = torch.where(improved, col_max, best)
        best_j = torch.where(improved, j, best_j)
        best_q = torch.where(improved, col_q, best_q)
    return best, best_q, best_j


def sw_score_endpos_torch(prof_aa: torch.Tensor, prof_ss: torch.Tensor,
                          t_aa: torch.Tensor, t_ss: torch.Tensor,
                          t_len: torch.Tensor, gap_open: int = 10,
                          gap_extend: int = 1):
    """Plain PyTorch version of `foldseek_tpu.ops.sw.sw_score_endpos`.

    prof_aa, prof_ss: int32 [21, Lq] (padded rows very negative); t_aa,
    t_ss: int [B, Lt] targets; t_len: int [B]. Every one of the Lq rows,
    padding included, counts as a query row, as in the XLA scan. Returns
    (score, q_end, t_end) int32 [B]."""
    B = t_aa.shape[0]
    Lq = prof_aa.shape[1]
    dev = prof_aa.device
    return sw_scan_torch(
        prof_aa[None].to(torch.int32), prof_ss[None].to(torch.int32),
        torch.tensor([Lq], device=dev), torch.zeros(B, dtype=torch.long,
                                                    device=dev),
        t_aa, t_ss, t_len, gap_open=gap_open, gap_extend=gap_extend)

"""Forward-backward posterior alignment (FwBwAligner)
(reference: lib/mmseqs/src/alignment/Fwbw.cpp).

Local pair alignment as a probability model: an alignment may start and end
at any cell, matches emit exp(S(i,j)/T), gaps weigh exp(go/T) to open and
exp(ge/T) to extend. The reference computes the partition function with
block-rescaled linear-space SIMD recurrences; here the same quantities run
in log space with numpy `logaddexp` scans — numerically stable without the
block bookkeeping, bitwise-identical in exact arithmetic:

  M(i,j) = S'(i,j) + log( e^{M(i-1,j-1)} + e^{E(i-1,j-1)} + e^{F(i-1,j-1)} + 1 )
  E(i,j) = logaddexp(go' + M(i,j-1), ge' + E(i,j-1))      (gap in rows)
  F(i,j) = logaddexp(go' + M(i-1,j), ge' + F(i-1,j))      (gap in cols)
  Z      = logsumexp_ij M(i,j)
  P(i,j) = exp( Mfwd(i,j) + Mbwd(i,j) - S'(i,j) - Z )

The row-internal E recurrence vectorizes as a shifted log-cumsum-exp:
E(i,j) = (j-1)*ge' + go' + logcumsumexp_k<j ( M(i,k) - k*ge' ).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -1e30


def _forward_m(s: np.ndarray, go: float, ge: float) -> np.ndarray:
    """Log-space forward match matrix M for score matrix s (already /T).

    Dispatches to the native host library when available (identical op
    order; the numpy row loop below is the semantics reference)."""
    from .. import native
    M_native = native.fwbw_forward_m(s, go, ge)
    if M_native is not None:
        return M_native
    L1, L2 = s.shape
    M = np.full((L1, L2), NEG)
    E_prev = np.full(L2, NEG)   # E(i-1, ·)
    F_prev = np.full(L2, NEG)   # F(i-1, ·)
    M_prev = np.full(L2, NEG)
    jj = np.arange(L2)
    for i in range(L1):
        # entry from diag of M/E/F at (i-1, j-1), or fresh start (0)
        diag = np.full(L2, 0.0)
        if i > 0:
            prev = np.logaddexp(np.logaddexp(M_prev, E_prev), F_prev)
            diag[1:] = np.logaddexp(prev[:-1], 0.0)
        M_row = s[i] + diag
        # E(i, j): within-row gaps over M(i, k<j)
        g = M_row - jj * ge
        run = np.logaddexp.accumulate(g)
        E_row = np.full(L2, NEG)
        E_row[1:] = (jj[1:] - 1) * ge + go + run[:-1]
        # F(i, j) from row i-1
        if i > 0:
            F_row = np.logaddexp(go + M_prev, ge + F_prev)
        else:
            F_row = np.full(L2, NEG)
        M[i] = M_row
        M_prev, E_prev, F_prev = M_row, E_row, F_row
    return M


def fwbw_posterior(score: np.ndarray, gap_open: float = -1.5,
                   gap_extend: float = -0.0,
                   temperature: float = 4.0) -> Tuple[np.ndarray, float]:
    """Posterior alignment probabilities P [L1, L2] and max P.

    Dispatches to the native scaled linear-space implementation (the
    reference's own formulation family); the log-space numpy path below
    is the semantics reference (exact vs brute force)."""
    from .. import native
    res = native.fwbw_posterior(np.asarray(score, dtype=np.float64),
                                gap_open, gap_extend, temperature)
    if res is not None:
        return res
    s = np.asarray(score, dtype=np.float64) / temperature
    go = gap_open / temperature
    ge = gap_extend / temperature
    fwd = _forward_m(s, go, ge)
    bwd = _forward_m(s[::-1, ::-1], go, ge)[::-1, ::-1]
    m = fwd.max()
    z = m + np.log(np.exp(fwd - m).sum())
    P = np.exp(fwd + bwd - s - z)
    return P, float(P.max())


def mac_backtrace(P: np.ndarray, mact: float = 0.0) -> list:
    """Maximum-accuracy alignment through the posterior matrix: DP over
    P(i,j) - mact with free gaps, returning matched (i, j) pairs
    (computeBacktrace semantics)."""
    L1, L2 = P.shape
    S = np.zeros((L1 + 1, L2 + 1))
    ptr = np.zeros((L1, L2), dtype=np.int8)
    for i in range(L1):
        for j in range(L2):
            diag = S[i, j] + P[i, j] - mact
            up = S[i, j + 1]
            left = S[i + 1, j]
            best = max(diag, up, left)
            S[i + 1, j + 1] = best
            ptr[i, j] = 0 if best == diag else (1 if best == up else 2)
    pairs = []
    i, j = L1 - 1, L2 - 1
    while i >= 0 and j >= 0:
        d = ptr[i, j]
        if d == 0:
            pairs.append((i, j))
            i -= 1
            j -= 1
        elif d == 1:
            i -= 1
        else:
            j -= 1
    return pairs[::-1]


class FwBwAligner:
    """Stateful wrapper mirroring the reference API surface."""

    def __init__(self, gap_open: float = -1.5, gap_extend: float = 0.0,
                 temperature: float = 4.0, mact: float = 0.0):
        self.reset_params(gap_open, gap_extend, temperature)
        self.mact = mact
        self.P = None
        self.max_p = 0.0

    def reset_params(self, gap_open, gap_extend, temperature):
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.temperature = temperature

    def run(self, score: np.ndarray) -> np.ndarray:
        self.P, self.max_p = fwbw_posterior(score, self.gap_open,
                                            self.gap_extend, self.temperature)
        return self.P

    def backtrace(self) -> list:
        return mac_backtrace(self.P, self.mact)

"""Plain numpy scoring of foldseek's GPU search: substitution tables, the
windowed composition-bias correction, query profiles and the E-value
network, from the frozen copies beside this file.

Semantics (foldseek / MMseqs2):
  * ungapped prefilter and `--prefilter-mode 3`: 3Di matrix at bit factor
    2.0 plus the query's composition bias at scale 0.15, computed against the
    3Di matrix (ungappedprefilter.cpp, StructureSearch.cpp:101); prefilter
    scores saturate at 255 less the profile's byte offset;
  * structurealign: 3Di at 2.1 plus BLOSUM62 at 1.4 per cell, each with a
    composition bias computed against BLOSUM62 (scale 1.0 for AA, 0.5 for
    3Di, StructureSmithWaterman.cpp:1564-1574), gap open 10, extend 1; the
    reversed query, with its bias recomputed, gives the score subtracted
    before the E-value (structurealign.cpp:345-347);
  * E-values from the E-value network's Gumbel (lambda, mu) of the query's
    3Di composition and length, with the size correction exponent 0.32
    (EvalueNeuralNet.h).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
GAP_OPEN, GAP_EXTEND = 10, 1
PREFILTER_BIAS_SCALE = 0.15
BYTE_CAP = 255
MIN_DIAG_SCORE = 15
EVALUE_EXPONENT = 0.32
MU1, SIGMA1 = 0.17518475184751847, 0.03260331312698818
MU2, SIGMA2 = -2.5569312493124934, 0.4353169278257701

with open(os.path.join(_HERE, "tables.json")) as _f:
    _T = json.load(_f)
M3DI_ALN = np.asarray(_T["mat3di_2.1"], dtype=np.int64)
M3DI_PREF = np.asarray(_T["mat3di_2.0"], dtype=np.int64)
M3DI_PREF_BACK = np.asarray(_T["mat3di_2.0_p_back"], dtype=np.float64)
BLOSUM = np.asarray(_T["blosum62_1.4"], dtype=np.int64)
BLOSUM_BACK = np.asarray(_T["blosum62_1.4_p_back"], dtype=np.float64)
_NN = None


def comp_bias(seq: np.ndarray, mat: np.ndarray, back: np.ndarray,
              scale: float) -> np.ndarray:
    """Per-position composition bias (SubstitutionMatrix::
    calcLocalAaBiasCorrection): minus the mean score of the position's
    letter against the other letters of a 40-wide window, plus its expected
    score against the background, in float32 as the reference sums it, times
    `scale`, rounded half away from zero to int8."""
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq)
    rows = mat[seq]                                 # [n, 21]
    s = rows[:, seq]                                # [n, n]
    i = np.arange(n)
    lo = np.maximum(0, i - 20)
    hi = np.minimum(n, i + 20)
    csum = np.zeros((n, n + 1), dtype=np.int64)
    np.cumsum(s, axis=1, out=csum[:, 1:])
    win = csum[i, hi] - csum[i, lo] - s[i, i]
    delta = (win.astype(np.float64) / (-1.0 * (hi - lo))).astype(np.float32)
    for a in range(mat.shape[0]):
        delta = (delta.astype(np.float64)
                 + back[a] * rows[:, a].astype(np.float64)).astype(np.float32)
    out = np.float32(scale) * delta
    return np.where(out < 0, out - 0.5, out + 0.5).astype(np.int8)


def ungapped_profile(ss: np.ndarray):
    """int64 [21, L] 3Di profile of the ungapped prefilter and of mode 3,
    and the prefilter's saturation cap."""
    ss = np.asarray(ss, dtype=np.int64)
    bias = comp_bias(ss, M3DI_PREF, M3DI_PREF_BACK, PREFILTER_BIAS_SCALE)
    prof = M3DI_PREF[:, ss] + bias[None, :].astype(np.int64)
    byte_bias = abs(int(M3DI_PREF.min())) + abs(min(int(bias.min()), 0))
    return prof, BYTE_CAP - byte_bias


def dual_profile(aa: np.ndarray, ss: np.ndarray):
    """(AA, 3Di) int64 [21, L] profiles of structurealign's 3Di+AA SW."""
    aa = np.asarray(aa, dtype=np.int64)
    ss = np.asarray(ss, dtype=np.int64)
    b_aa = comp_bias(aa, BLOSUM, BLOSUM_BACK, 1.0).astype(np.int64)
    b_ss = comp_bias(ss, BLOSUM, BLOSUM_BACK, 0.5).astype(np.int64)
    return BLOSUM[:, aa] + b_aa[None, :], M3DI_ALN[:, ss] + b_ss[None, :]


def _network():
    global _NN
    if _NN is None:
        z = np.load(os.path.join(_HERE, "evalue_nn.npz"))
        _NN = [(z[f"w{i}"].astype(np.float32), z[f"b{i}"].astype(np.float32),
                str(z[f"act{i}"])) for i in range(int(z["n_layers"]))]
    return _NN


@dataclass
class Evalue:
    """E-values of one query against a DB of `db_residues` residues."""
    lam: float
    mu: float
    log_db: float

    @classmethod
    def of(cls, ss: np.ndarray, db_residues: int) -> "Evalue":
        x = np.zeros(22, dtype=np.float32)
        x[:21] = np.bincount(np.asarray(ss, dtype=np.int64),
                             minlength=21)[:21]
        x[21] = len(ss)
        h = x
        for w, b, act in _network():
            h = h @ w + b
            if act == "relu":
                h = np.maximum(h, np.float32(0))
        # the first output is used as lambda, the second as mu
        return cls(float(h[0]) * SIGMA1 + MU1, float(h[1]) * SIGMA2 + MU2,
                   math.log(float(db_residues)))

    def __call__(self, score: float) -> float:
        h = self.lam * (float(score) - self.mu)
        if h > 10:
            log_p = -h
        elif h < -2.5:
            log_p = -math.exp(-math.exp(-h))
        else:
            log_p = math.log(1.0 - math.exp(-math.exp(-h)))
        return math.exp(log_p + self.log_db) ** EVALUE_EXPONENT

"""E-value neural network: per-query Gumbel (lambda, mu) prediction.

4-layer MLP over the query's 3Di composition (21 counts) + length, outputs
de-normalized with hardcoded (mean, sigma) pairs
(reference: src/strucclustutils/EvalueNeuralNet.cpp:19-34). The E-value is a
Gumbel tail with a size correction exponent 0.32 (EvalueNeuralNet.h:24-45).

Note the reference's naming: predictMuLambda's first output is used as the
*lambda* argument of computeEvalueCorr and the second as *mu*
(structurealign.cpp:55 with EvalueNeuralNet.h:38).
"""
from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

MU1, SIGMA1 = 0.17518475184751847, 0.03260331312698818
MU2, SIGMA2 = -2.5569312493124934, 0.4353169278257701

_weights = None


def _mlp():
    global _weights
    if _weights is None:
        z = np.load(os.path.join(_DATA, "evalue_nn.npz"))
        _weights = [(z[f"w{i}"], z[f"b{i}"], str(z[f"act{i}"])) for i in range(int(z["n_layers"]))]
    return _weights


class EvalueComputer:
    def __init__(self, db_res_count: int):
        self.log_db_res = np.log(float(db_res_count))

    def predict_lambda_mu(self, ss_num: np.ndarray) -> tuple:
        """Counts of the 21 3Di letters + L -> (lambda, mu), float32 MLP."""
        x = np.zeros(22, dtype=np.float32)
        counts = np.bincount(np.asarray(ss_num, dtype=np.int64), minlength=21)
        x[:21] = counts.astype(np.float32)
        x[21] = np.float32(len(ss_num))
        h = x
        for w, b, act in _mlp():
            h = h @ w + b
            if act == "relu":
                h = np.maximum(h, np.float32(0))
        return (float(h[0]) * SIGMA1 + MU1, float(h[1]) * SIGMA2 + MU2)

    @staticmethod
    def log_pvalue(score: float, lam: float, mu: float) -> float:
        """reference: EvalueNeuralNet.h computePvalue (returns log P)."""
        h = lam * (score - mu)
        if h > 10:
            return -h
        if h < -2.5:
            return -np.exp(-np.exp(-h))
        return float(np.log(1.0 - np.exp(-np.exp(-h))))

    def evalue_corr(self, score: float, lam: float, mu: float) -> float:
        log_pval = self.log_pvalue(score, lam, mu)
        evalue = np.exp(log_pval + self.log_db_res)
        return float(np.power(evalue, 0.32))

    def evalue_corr_batch(self, scores: np.ndarray, lam: float, mu: float) -> np.ndarray:
        """Vectorized evalue_corr over int scores."""
        s = np.asarray(scores, dtype=np.float64)
        h = lam * (s - mu)
        with np.errstate(over="ignore", under="ignore"):
            log_p = np.where(
                h > 10, -h,
                np.where(h < -2.5, -np.exp(-np.exp(-h)),
                         np.log(np.maximum(1.0 - np.exp(-np.exp(-np.clip(h, -50, 50))), 1e-300))))
        return np.power(np.exp(log_p + self.log_db_res), 0.32)

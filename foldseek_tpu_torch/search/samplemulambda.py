"""samplemulambda: per-query Gumbel (mu, lambda) estimation from alignments
against shuffled targets — the training-data generator for the E-value
neural net (reference: src/strucclustutils/samplemulambda.cpp: ran2-shuffled
targets, score-only structural SW, EVD maximum-likelihood fit; the fit is
the classic HMMER EvdMaxLikelyFit Newton iteration on lambda).

Counterpart of `foldseek_tpu/search/samplemulambda.py`; the score pass is one
`sw_scores_pairs` call (every query a slot, the shuffled targets its pairs)
instead of one XLA scan a query.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

import torch

from ..db.storage import StructDB
from ..ops.sw import QueryProfile
from ..ops.sw_kernels import pack_sw_slots, sw_scores_pairs
from ..utils.log import logger


def evd_max_likelihood_fit(scores: np.ndarray) -> Tuple[float, float]:
    """Maximum-likelihood Gumbel fit; Newton on lambda then closed-form mu
    (Lawless 1982, as in the reference's esl/squid-derived fit)."""
    x = np.asarray(scores, dtype=np.float64)
    lam = 0.2
    for _ in range(100):
        e = np.exp(-lam * x)
        s0 = e.sum()
        s1 = (x * e).sum()
        s2 = (x * x * e).sum()
        f = 1.0 / lam - x.mean() + s1 / s0
        df = -1.0 / (lam * lam) + (s1 * s1 - s0 * s2) / (s0 * s0)
        step = f / df
        lam -= step
        if lam <= 0:
            lam = 0.001
        if abs(step) < 1e-7:
            break
    mu = -np.log(np.exp(-lam * x).mean()) / lam
    return float(mu), float(lam)


def sample_mu_lambda(qdb: StructDB, tdb: StructDB, device: torch.device,
                     n_samples: int = 100, seed: int = 42, gap_open: int = 10,
                     gap_extend: int = 1) -> Dict[int, Tuple[float, float]]:
    """For every query: SW scores against n_samples shuffled targets, EVD
    fit. Returns key -> (mu, lambda)."""
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    # sample target sequences (with replacement) once, shuffle residues
    t_idx = rng.randint(0, tdb.size, size=n_samples)
    shuffled = []
    for ti in t_idx:
        aa = np.asarray(tdb.get_aa(ti)).copy()
        ss = np.asarray(tdb.get_ss(ti)).copy()
        perm = rng.permutation(len(aa))
        shuffled.append((aa[perm], ss[perm]))
    t_len = np.asarray([len(aa) for aa, _ in shuffled], dtype=np.int64)
    t_off = np.zeros(n_samples, dtype=np.int64)
    np.cumsum(t_len[:-1], out=t_off[1:])
    res_aa, res_ss = (
        torch.from_numpy(np.concatenate([s[k] for s in shuffled])
                         .astype(np.int8)).to(device) for k in (0, 1))

    profs = [QueryProfile(np.asarray(qdb.get_aa(qi)),
                          np.asarray(qdb.get_ss(qi)),
                          gap_open=gap_open, gap_extend=gap_extend)
             for qi in range(qdb.size)]
    paa, pss, slot_off = pack_sw_slots([p.prof_aa for p in profs],
                                       [p.prof_ss for p in profs])
    pair_start = np.arange(qdb.size + 1, dtype=np.int64) * n_samples
    scores, _, _ = sw_scores_pairs(
        torch.from_numpy(paa).to(device), torch.from_numpy(pss).to(device),
        slot_off, pair_start, res_aa, res_ss, np.tile(t_off, qdb.size),
        np.tile(t_len, qdb.size), gap_open, gap_extend)
    scores = scores.cpu().numpy().reshape(qdb.size, n_samples)
    out = {}
    for qi in range(qdb.size):
        mu, lam = evd_max_likelihood_fit(scores[qi])
        out[int(qdb.keys[qi])] = (mu, lam)
    logger.info("samplemulambda: fitted %d queries over %d shuffles",
                qdb.size, n_samples)
    return out

"""ALP (Sls) Gumbel e-value model with finite-size correction, as used by
the reference's EvalueComputation for the MMseqs2-side verbs (swapresults,
transitivealign; reference: lib/mmseqs/src/alignment/EvalueComputation.h,
lib/mmseqs/lib/alp/sls_pvalues.cpp:366-542 get_appr_tail_prob_with_cov_
without_errors, lib/mmseqs/lib/alp/sls_alignment_evaluer.cpp:989 area).

The twelve Gumbel parameters are a Monte-Carlo fit the reference runs at
startup (sls_alignment_evaluer initGapped, fixed random seed 42 ->
deterministic). They cannot be re-fit here without the ALP library, so the
fits for the scoring systems foldseek actually constructs are pinned below,
extracted by running the reference's own fit (same matrix file, bit factor
2.0, score bias 0.0, seed 42) and dumping Sls::AlignmentEvaluer::parameters().
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class GumbelParams:
    """Sls::ALP_set_of_parameters subset used by the e-value formulas."""
    lambda_: float
    K: float
    a_J: float
    b_J: float
    a_I: float
    b_I: float
    alpha_J: float
    beta_J: float
    alpha_I: float
    beta_I: float
    sigma: float
    tau: float


# mat3di.out, bit factor 2.0, score bias 0.0, gapOpen 10, gapExtend 1 —
# foldseek's default swapresults evaluer (swapresults.cpp:95-99 with
# LocalParameters scoringMatrixFile="3di.out", gapOpen=10, gapExtend=1).
MAT3DI_GAP_10_1 = GumbelParams(
    lambda_=0.31605198425120906,
    K=0.11893366155601298,
    a_J=0.68129582053522797, b_J=-6.6831695347454465,
    a_I=0.68129582053522797, b_I=-6.6831695347454465,
    alpha_J=4.8867928625442278, beta_J=-91.468673321996917,
    alpha_I=4.8867928625442278, beta_I=-91.468673321996917,
    sigma=4.4242911433666832, tau=-81.293635500090929)

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# nat_cut_off_in_max, sls_pvalues.cpp:46
_NAT_CUT_OFF = 2.0


def _normal_probability(x: float) -> float:
    """sls_basic.hpp:195 — Phi(x) = 0.5*erfc(-x/sqrt(2))."""
    return 0.5 * math.erfc(-math.sqrt(0.5) * x)


class AlpEvaluer:
    """EvalueComputation over a fitted Gumbel parameter set.

    db_res_count is the residue count of the (new) target DB — the
    reference builds the swap evaluer over db1, the original query DB
    (swapresults.cpp:76 getAminoAcidDBSize)."""

    def __init__(self, db_res_count: float,
                 params: GumbelParams = MAT3DI_GAP_10_1):
        self.p = params
        self.db_res_count = float(db_res_count)
        self.log_k = math.log(params.K)
        lam = params.lambda_
        # pvalues::compute_tmp_values (sls_pvalues.cpp:342-364)
        self.vi_y_thr = max(_NAT_CUT_OFF * params.alpha_I / lam, 0.0)
        self.vj_y_thr = max(_NAT_CUT_OFF * params.alpha_J / lam, 0.0)
        self.c_y_thr = max(_NAT_CUT_OFF * params.sigma / lam, 0.0)

    def raw_score_from_bit_score(self, bit_score: float) -> float:
        """EvalueComputation::computeRawScoreFromBitScore."""
        return (self.log_k + bit_score * math.log(2.0)) / self.p.lambda_

    def area(self, score: float, seq_length: float) -> float:
        """AlignmentEvaluer::area(score, seqlen, dbResCount) ->
        get_appr_tail_prob_with_cov_without_errors with m_=dbResCount
        (I side), n_=seqlen (J side)."""
        p, y = self.p, score
        m, n = self.db_res_count, float(seq_length)

        m_li_y = m - (p.a_I * y + p.b_I)
        vi_y = max(self.vi_y_thr, p.alpha_I * y + p.beta_I)
        sqrt_vi_y = math.sqrt(vi_y)
        m_f = m_li_y / sqrt_vi_y if sqrt_vi_y != 0.0 else 1e100
        p_m_f = _normal_probability(m_f)
        e_m_f = -_INV_SQRT_2PI * math.exp(-0.5 * m_f * m_f)
        p1 = m_li_y * p_m_f - sqrt_vi_y * e_m_f

        n_lj_y = n - (p.a_J * y + p.b_J)
        vj_y = max(self.vj_y_thr, p.alpha_J * y + p.beta_J)
        sqrt_vj_y = math.sqrt(vj_y)
        n_f = n_lj_y / sqrt_vj_y if sqrt_vj_y != 0.0 else 1e100
        p_n_f = _normal_probability(n_f)
        e_n_f = -_INV_SQRT_2PI * math.exp(-0.5 * n_f * n_f)
        p2 = n_lj_y * p_n_f - sqrt_vj_y * e_n_f

        c_y = max(self.c_y_thr, p.sigma * y + p.tau)
        return p1 * p2 + c_y * p_m_f * p_n_f

    def evalue_per_area(self, score: float) -> float:
        """AlignmentEvaluer::evaluePerArea = K*exp(-lambda*score)."""
        return self.p.K * math.exp(-self.p.lambda_ * score)

    def compute_evalue(self, score: float, seq_length: float) -> float:
        """EvalueComputation::computeEvalue = evaluePerArea * area."""
        return self.evalue_per_area(score) * self.area(score, seq_length)

    def swapped_evalue(self, bit_score: float, t_len: float) -> float:
        """Matcher::result_t::swapResult: recompute the e-value from the
        stored bit score against the pre-swap target length (the new
        query length) and the new target DB size."""
        raw = self.raw_score_from_bit_score(bit_score)
        return self.compute_evalue(raw, t_len)

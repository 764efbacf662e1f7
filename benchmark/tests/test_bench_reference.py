"""The plain reference against brute-force loops at tiny sizes, and its
frozen tables and formulas against the program's own (CPU only)."""
import numpy as np
import pytest
import torch

from benchmark.gen import families as F
from benchmark.reference import dp, expect, scoring, structure

NEG = -(10 ** 9)


def brute_ungapped(prof, cap, t):
    lq, best = prof.shape[1], 0
    for d in range(-lq + 1, len(t)):
        h = 0
        for i in range(lq):
            j = i + d
            if 0 <= j < len(t):
                h = min(max(h + int(prof[t[j], i]), 0), cap)
                best = max(best, h)
    return best


def brute_sw(pa, ps, ta, ts, go=10, ge=1, sat=None):
    """Column-major Gotoh with the lazy-F rule, scalar loops."""
    lq = pa.shape[1]
    H, E = [0] * lq, [NEG] * lq
    best, bj, bq = 0, 0, lq - 1
    for j in range(len(ta)):
        hnf = []
        for i in range(lq):
            diag = H[i - 1] if i else 0
            hnf.append(max(diag + int(pa[ta[j], i]) + int(ps[ts[j], i]),
                           E[i], 0))
        newH = []
        for i in range(lq):
            f = max([hnf[k] - go - (i - 1 - k) * ge for k in range(i)],
                    default=NEG)
            h = max(hnf[i], f)
            newH.append(min(h, sat) if sat is not None else h)
        for i in range(lq):
            E[i] = max(E[i] - ge, hnf[i] - go)
        H = newH
        col = max(H)
        if col > best:
            best, bj, bq = col, j, H.index(col)
    return best, bq, bj


@pytest.fixture(scope="module")
def tiny():
    cfg = dict(entries=60, length_mean=40, length_sigma=0.5, length_max=90,
               length_min=8, ancestor_length_min=12, family_size_exponent=2.0,
               family_size_max=10, crop_keep_min=0.6, aa_sub_min=0.05,
               aa_sub_max=0.7, ss_sub_ratio=0.5, indel_rate=0.02,
               indel_mean=3.0, jitter_min=0.35, jitter_max=1.5)
    g = F.make_db(cfg, 3)
    q = F.make_queries(g, cfg, 4, 3)
    return g.db, q


def seq(r, i, what):
    return getattr(r, what)[r.offsets[i]:r.offsets[i + 1]]


def test_ungapped_matches_brute_force(tiny):
    db, q = tiny
    tables = dp.TargetTables(db.ss, db.offsets, "cpu")
    for i in range(q.size):
        ss = seq(q, i, "ss")
        prof, cap = scoring.ungapped_profile(ss)
        got = dp.ungapped_all(prof, cap, tables, ss)
        want = [brute_ungapped(prof, cap, seq(db, t, "ss"))
                for t in range(db.size)]
        assert got.tolist() == want
    # a cap that binds
    prof, _ = scoring.ungapped_profile(seq(q, 0, "ss"))
    got = dp.ungapped_all(prof, 20, tables, seq(q, 0, "ss"))
    assert got.tolist() == [brute_ungapped(prof, 20, seq(db, t, "ss"))
                            for t in range(db.size)]


def test_sw_all_matches_brute_force(tiny):
    db, q = tiny
    tables = dp.TargetTables(db.ss, db.offsets, "cpu")
    for i in range(2):
        ss = seq(q, i, "ss")
        prof, _ = scoring.ungapped_profile(ss)
        s, qe, te = dp.sw_all(prof, ss, tables)
        za = np.zeros_like(prof)
        for t in range(db.size):
            tss = seq(db, t, "ss")
            want = brute_sw(za, prof, np.zeros(len(tss), np.int64), tss)
            assert (s[t], qe[t], te[t]) == want


def test_sw_pairs_dual_and_saturated_match_brute_force(tiny):
    db, q = tiny
    aa, ss = seq(q, 1, "aa"), seq(q, 1, "ss")
    fwd = scoring.dual_profile(aa, ss)
    rev = scoring.dual_profile(aa[::-1], ss[::-1])
    targets = list(range(0, db.size, 3))
    t_aa = [seq(db, t, "aa") for t in targets]
    t_ss = [seq(db, t, "ss") for t in targets]
    for sat in (None, 40):
        out = dp.sw_pairs([fwd, rev], t_aa, t_ss, "cpu", sat=sat)
        for k in range(len(targets)):
            for p, prof in enumerate((fwd, rev)):
                want = brute_sw(prof[0], prof[1], t_aa[k], t_ss[k], sat=sat)
                assert tuple(out[p, :, k]) == want


def test_mode3_expectation_orders_and_cuts(tiny):
    db, q = tiny
    tables = dp.TargetTables(db.ss, db.offsets, "cpu")
    params = dict(evalue_thr=10.0, max_seqs=5)
    got = expect.mode3(seq(q, 0, "ss"), db, tables, params)
    assert len(got) <= 5
    keys = [(e["evalue"], -e["score"], db.offsets[e["key"] + 1]
             - db.offsets[e["key"]], e["key"]) for e in got]
    assert keys == sorted(keys)


# --- the frozen tables and formulas against the program's own ------------

def test_tables_and_bias_match_the_program(tiny):
    from foldseek_tpu_torch.ops.matrices import blosum62, mat3di
    from foldseek_tpu_torch.ops.sw import QueryProfile, calc_comp_bias
    from foldseek_tpu_torch.search.ungapped import make_query_profile
    db, q = tiny
    assert np.array_equal(scoring.M3DI_ALN, mat3di().scores)
    assert np.array_equal(scoring.BLOSUM, blosum62().scores)
    for i in range(q.size):
        aa, ss = seq(q, i, "aa"), seq(q, i, "ss")
        m = mat3di(2.0, 0.0)
        assert np.array_equal(
            scoring.comp_bias(ss, scoring.M3DI_PREF, scoring.M3DI_PREF_BACK,
                              0.15),
            calc_comp_bias(ss, m.scores, m.p_back, 0.15))
        prof, cap = scoring.ungapped_profile(ss)
        p2, b2 = make_query_profile(ss)
        assert np.array_equal(prof, p2) and cap == 255 - b2
        qp = QueryProfile(aa, ss)
        fa, fs = scoring.dual_profile(aa, ss)
        assert np.array_equal(fa, qp.prof_aa) and np.array_equal(fs, qp.prof_ss)
        ra, rs = scoring.dual_profile(aa[::-1], ss[::-1])
        rq = qp.reversed()
        assert np.array_equal(ra, rq.prof_aa) and np.array_equal(rs, rq.prof_ss)


def test_evalues_match_the_program(tiny):
    from foldseek_tpu_torch.nn.evalue import EvalueComputer
    db, q = tiny
    ss = seq(q, 2, "ss")
    ev = scoring.Evalue.of(ss, 180_000_000)
    prog = EvalueComputer(180_000_000)
    lam, mu = prog.predict_lambda_mu(ss)
    assert (ev.lam, ev.mu) == (lam, mu)
    for s in (-5, 0, 16, 40, 90, 400, 3000):
        assert ev(s) == pytest.approx(prog.evalue_corr(s, lam, mu), rel=1e-12)


def test_structure_scores_match_the_program(tiny):
    from foldseek_tpu_torch.ops.lddt import compute_lddt
    from foldseek_tpu_torch.ops.tmscore import compute_tm_score
    db, _q = tiny
    rng = np.random.default_rng(0)
    fam = db.family
    pairs = [tuple(np.flatnonzero(fam == f)[:2]) for f in np.unique(fam)
             if np.count_nonzero(fam == f) >= 2][:6]
    assert pairs
    for a, b in pairs:
        qa, tb = seq(db, a, "ca"), seq(db, b, "ca")
        n = min(len(qa), len(tb)) - 4
        ops = rng.choice(list("MMMMMMID"), size=n)
        bt = "".join(ops)
        qn = bt.count("M") + bt.count("I")
        tn = bt.count("M") + bt.count("D")
        if qn > len(qa) or tn > len(tb):
            continue
        norm = min(qn - 1, tn - 1)
        want_tm = compute_tm_score(qa, tb, 0, 0, bt, norm).tmscore
        got_tm = structure.tm_score(qa, tb, 0, 0, bt, norm)
        # the program's native engine keeps some sums in float32
        assert got_tm == pytest.approx(want_tm, abs=1e-6)
        want_ld = compute_lddt(qa, tb, 0, 0, bt).avg_lddt
        assert structure.lddt(qa, tb, 0, 0, bt) == pytest.approx(want_ld,
                                                                 abs=1e-5)

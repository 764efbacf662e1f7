"""The port's plain Smith-Waterman (foldseek_tpu_torch.ops.sw_kernels /
ops.sw, run here on CPU tensors) equals the JAX package's kernels and
oracles exactly: score, query end and target end.

One exclusion: for a pair whose best score stays 0, the JAX side reports
q_end = (padded query length - 1), an artefact of its row padding
(sw_pallas.py:102, ops/sw.py:232); the port reports slot length - 1. Such
pairs never pass the E-value gate, so q_end is compared only where the
score is > 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldseek_tpu.ops import sw as jsw
from foldseek_tpu.ops import sw_pallas as jsp
from foldseek_tpu_torch.ops import sw as tsw
from foldseek_tpu_torch.ops import sw_kernels as tk

import _torch_adapters as ad


def _seq(rng, L):
    return (rng.randint(0, 20, L).astype(np.int8),
            rng.randint(0, 20, L).astype(np.int8))


def _padded_targets(rng, B, Lt, lo=10):
    t_aa = rng.randint(0, 20, (B, Lt)).astype(np.int8)
    t_ss = rng.randint(0, 20, (B, Lt)).astype(np.int8)
    t_len = rng.randint(lo, Lt + 1, B).astype(np.int32)
    for i in range(B):
        t_aa[i, t_len[i]:] = 21
        t_ss[i, t_len[i]:] = 21
    return t_aa, t_ss, t_len


def _assert_endpos(got, want):
    score, qend, tend = (np.asarray(x).astype(np.int64) for x in got)
    w_score, w_qend, w_tend = (np.asarray(x).astype(np.int64) for x in want)
    assert np.array_equal(score, w_score)
    assert np.array_equal(tend, w_tend)
    pos = w_score > 0
    assert np.array_equal(qend[pos], w_qend[pos])
    return int(pos.sum())


def test_batch_multi_matches_jax():
    """S=2 stacks x q=4 slots (forward + reversed profile of two queries
    each), every stack against its own 128 targets."""
    rng = np.random.RandomState(11)
    S, q, B, Lt, lq_pad = 2, 4, 128, 64, 64
    slots = []
    for _ in range(S * q // 2):
        prof = tsw.QueryProfile(*_seq(rng, int(rng.randint(20, 60))))
        slots += [prof, prof.reversed()]
    targets = [_padded_targets(rng, B, Lt) for _ in range(S)]
    # JAX side: packed stacks + transposed panels
    j_in = [jsp.pack_sw_profiles_batch(
        [p.prof_aa for p in slots[s * q:(s + 1) * q]],
        [p.prof_ss for p in slots[s * q:(s + 1) * q]], lq_pad)
        for s in range(S)]
    want = jsp.sw_scores_batch_multi(
        *(jnp.asarray(np.concatenate([x[i] for x in j_in])) for i in range(4)),
        jnp.asarray(np.concatenate([t[0].T for t in targets])),
        jnp.asarray(np.concatenate([t[1].T for t in targets])),
        jnp.asarray(np.stack([t[2] for t in targets])), S, q, lq_pad)
    paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in slots],
                                          [p.prof_ss for p in slots])
    got = ad.sw_scores_batch_multi(
        torch.from_numpy(paa), torch.from_numpy(pss), slot_off,
        torch.from_numpy(np.stack([t[0] for t in targets])),
        torch.from_numpy(np.stack([t[1] for t in targets])),
        torch.from_numpy(np.stack([t[2] for t in targets])), S, q)
    assert _assert_endpos(got, want) > S * q * B // 2


def test_query_matches_jax_pallas():
    rng = np.random.RandomState(7)
    Lq, B, Lt = 64, 128, 64
    prof = tsw.QueryProfile(*_seq(rng, Lq))
    pa, ps = prof.padded(Lq)
    t_aa, t_ss, t_len = _padded_targets(rng, B, Lt)
    want = jsp.sw_scores_query(
        jnp.asarray(jsp.pack_sw_profile(pa)), jnp.asarray(jsp.pack_sw_profile(ps)),
        jnp.asarray(t_aa.T.astype(np.int32)), jnp.asarray(t_ss.T.astype(np.int32)),
        jnp.asarray(t_len))
    got = ad.sw_scores_query(torch.from_numpy(prof.prof_aa),
                             torch.from_numpy(prof.prof_ss),
                             torch.from_numpy(t_aa), torch.from_numpy(t_ss),
                             t_len)
    # here the JAX profile has no pad rows, so even q_end agrees everywhere
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("Lq,lq_pad", [(50, 64), (2100, 2100), (2100, 2176)])
def test_score_endpos_torch_matches_xla(Lq, lq_pad):
    """sw_score_endpos_torch is the XLA column scan, padding semantics
    included; the pair version on the true length agrees where score > 0.
    Lq = 2100 is beyond the TPU kernels' 2048-row limit."""
    rng = np.random.RandomState(Lq + lq_pad)
    prof = tsw.QueryProfile(*_seq(rng, Lq))
    pa, ps = prof.padded(lq_pad)
    t_aa, t_ss, t_len = _padded_targets(rng, 12, 90)
    want = [np.asarray(x) for x in jsw.sw_score_endpos(
        jnp.asarray(pa), jnp.asarray(ps), jnp.asarray(t_aa.astype(np.int32)),
        jnp.asarray(t_ss.astype(np.int32)), jnp.asarray(t_len))]
    got = tsw.sw_score_endpos_torch(
        torch.from_numpy(pa), torch.from_numpy(ps), torch.from_numpy(t_aa),
        torch.from_numpy(t_ss), torch.from_numpy(t_len))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    pairs = ad.sw_scores_query(torch.from_numpy(prof.prof_aa),
                               torch.from_numpy(prof.prof_ss),
                               torch.from_numpy(t_aa), torch.from_numpy(t_ss),
                               t_len)
    _assert_endpos(pairs, want)


def test_pairs_match_scalar_oracle_with_ties_and_long_query():
    """sw_scores_pairs (plain) against sw_score_endpos_np, pair by pair:
    constructed ties and a 2300-residue query. Slot 0 holds a motif twice
    (its column max is reached at two query rows against the bare motif);
    slot 1 is the motif, against a target that holds it twice (the best
    score is reached at two target columns)."""
    rng = np.random.RandomState(21)
    m = _seq(rng, 25)
    n = _seq(rng, 30)
    twice = tuple(np.concatenate([a, b, a]) for a, b in zip(m, n))
    # no composition bias on the tie slots: it would give the two copies
    # of the motif different profiles
    profs = [tsw.QueryProfile(*twice, comp_bias_correction=False),
             tsw.QueryProfile(*m, comp_bias_correction=False),
             tsw.QueryProfile(*_seq(rng, 2300))]
    res = [m, twice] + [_seq(rng, int(rng.randint(40, 120))) for _ in range(6)]
    pairs = [(0, 0), (0, 2), (1, 1), (1, 3), (2, 4), (2, 5), (2, 6), (2, 7)]
    lens = np.array([len(a) for a, _ in res])
    offs = np.concatenate([[0], np.cumsum(lens)])
    tids = np.array([t for _, t in pairs])
    paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in profs],
                                          [p.prof_ss for p in profs])
    got = tk.sw_scores_pairs(
        torch.from_numpy(paa), torch.from_numpy(pss), slot_off, [0, 2, 4, 8],
        torch.from_numpy(np.concatenate([a for a, _ in res])),
        torch.from_numpy(np.concatenate([s for _, s in res])),
        offs[tids], lens[tids])
    want = np.array([jsw.sw_score_endpos_np(profs[q].prof_aa,
                                            profs[q].prof_ss, *res[t])
                     for q, t in pairs]).T
    _assert_endpos(got, want)
    score, qend, tend = (x.numpy() for x in got)
    # the second copy of the motif scores as much as the first ...
    assert score[0] == score[2] and score[0] == jsw.sw_score_endpos_np(
        profs[1].prof_aa, profs[1].prof_ss, *m)[0]
    # ... and the ties go to the first copy: smallest query row, first column
    assert qend[0] == 24 and tend[2] == 24


def test_reversed_slots_like_pair_scorer():
    """Forward and reversed slots of several queries against shared
    candidates, the layout PairScorer builds."""
    rng = np.random.RandomState(4)
    profs = [tsw.QueryProfile(*_seq(rng, L)) for L in (30, 140, 75)]
    res = [_seq(rng, int(rng.randint(20, 160))) for _ in range(15)]
    lens = np.array([len(a) for a, _ in res])
    offs = np.concatenate([[0], np.cumsum(lens)])
    slots = [p for q in profs for p in (q, q.reversed())]
    cands = [rng.choice(15, 9, replace=False) for _ in profs]
    tids = np.concatenate([c for c in cands for _ in range(2)])
    paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in slots],
                                          [p.prof_ss for p in slots])
    got = tk.sw_scores_pairs(
        torch.from_numpy(paa), torch.from_numpy(pss), slot_off,
        np.arange(len(slots) + 1) * 9,
        torch.from_numpy(np.concatenate([a for a, _ in res])),
        torch.from_numpy(np.concatenate([s for _, s in res])),
        offs[tids], lens[tids])
    want = np.array([jsw.sw_score_endpos_np(
        slots[i // 9].prof_aa, slots[i // 9].prof_ss, *res[t])
        for i, t in enumerate(tids)]).T
    _assert_endpos(got, want)


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.RandomState(8)
    prof = tsw.QueryProfile(*_seq(rng, 40))
    t_aa, t_ss, t_len = _padded_targets(rng, 5, 30)
    before = tk.sw_scores_pairs.launches
    ad.sw_scores_query(torch.from_numpy(prof.prof_aa),
                       torch.from_numpy(prof.prof_ss), torch.from_numpy(t_aa),
                       torch.from_numpy(t_ss), t_len)
    assert tk.sw_scores_pairs.launches == before


def test_batch_matches_jax():
    """K7's contract: q = 4 slots sharing one list of 128 targets, built as
    tests/test_sw_parity.py builds `sw_scores_batch`'s inputs; the adapter
    over `sw_scores_pairs` equals the Pallas kernel in interpret mode and
    the scalar oracle. Exact (q_end where the score is > 0, see above)."""
    rng = np.random.RandomState(23)
    q, lq_pad, Lt, B = 4, 64, 96, 128
    profs_aa = [rng.randint(-8, 9, (21, L)).astype(np.float32)
                for L in rng.randint(20, lq_pad - 1, q)]
    profs_ss = [rng.randint(-8, 9, p.shape).astype(np.float32)
                for p in profs_aa]
    t_aa, t_ss, t_len = _padded_targets(rng, B, Lt)
    want = jsp.sw_scores_batch(
        *(jnp.asarray(x) for x in jsp.pack_sw_profiles_batch(
            profs_aa, profs_ss, lq_pad)),
        jnp.asarray(t_aa.T.astype(np.int32)),
        jnp.asarray(t_ss.T.astype(np.int32)), jnp.asarray(t_len), q, lq_pad)
    paa, pss, slot_off = tk.pack_sw_slots(profs_aa, profs_ss)
    got = ad.sw_scores_batch(
        torch.from_numpy(paa), torch.from_numpy(pss), slot_off,
        torch.from_numpy(t_aa), torch.from_numpy(t_ss),
        torch.from_numpy(t_len), q)
    assert all(x.shape == (q, B) and x.dtype == torch.int32 for x in got)
    assert _assert_endpos(got, want) > q * B // 2
    for k in range(q):
        for b in range(0, B, 17):
            s, qe, te = jsw.sw_score_endpos_np(
                profs_aa[k].astype(np.int64), profs_ss[k].astype(np.int64),
                t_aa[b, :t_len[b]], t_ss[b, :t_len[b]])
            assert (int(got[0][k, b]), int(got[2][k, b])) == (s, te)
            assert s == 0 or int(got[1][k, b]) == qe

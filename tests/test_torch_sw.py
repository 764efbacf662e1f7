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
from foldseek_tpu_torch.utils.log import stage_count

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
    before = stage_count("launches.sw")
    ad.sw_scores_query(torch.from_numpy(prof.prof_aa),
                       torch.from_numpy(prof.prof_ss), torch.from_numpy(t_aa),
                       torch.from_numpy(t_ss), t_len)
    assert stage_count("launches.sw") == before


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


# --- the kernel's recurrence, modelled in numpy -------------------------------

NEG_INF = -(1 << 30)
PAD_SCORE = -4096


def sw_wavefront_model(prof_aa, prof_ss, t_aa, t_ss, go, ge, G, S):
    """csrc/sw.cu step by step for one pair: a group of G lanes, lane l
    owning S consecutive query rows and working on column t - l at step t;
    F carried down the rows of a lane in a register and handed to the next
    lane with the last row's H; slots taller than G * S rows in passes
    through a scratch row; per-lane best on strict improvement, merged over
    passes and reduced over lanes by (score max, column min, row min)."""
    Lq, tlen, T = prof_aa.shape[1], len(t_aa), G * S
    npass = -(-Lq // T)
    scr = np.zeros((max(tlen, 1), 2), dtype=np.int64)
    best = [(0, 0, Lq - 1)] * G                      # (score, column, row)
    for p in range(npass):
        base = p * T
        n = min(T, Lq - base)
        tile_aa = np.full((21, T), PAD_SCORE, dtype=np.int64)
        tile_ss = tile_aa.copy()
        tile_aa[:, :n] = prof_aa[:, base:base + n]
        tile_ss[:, :n] = prof_ss[:, base:base + n]
        H = np.zeros((G, S), dtype=np.int64)
        E = np.full((G, S), NEG_INF, dtype=np.int64)
        pbest = [(0, 0, 0)] * G
        diag0 = [0] * G
        hout, fout = [0] * G, [NEG_INF] * G
        new_scr = scr.copy()
        for t in range(tlen + G - 1):
            sent_h, sent_f = list(hout), list(fout)  # what shfl_up delivers
            for l in range(G):
                j = t - l
                if not 0 <= j < tlen:
                    continue
                if l == 0:
                    hin, fin = (scr[j] if p > 0 else (0, NEG_INF))
                else:
                    hin, fin = sent_h[l - 1], sent_f[l - 1]
                ca, cs = min(int(t_aa[j]), 20), min(int(t_ss[j]), 20)
                diag, F, m = diag0[l], fin, 0
                for k in range(S):
                    s = tile_aa[ca, l * S + k] + tile_ss[cs, l * S + k]
                    hn = max(diag + s, E[l, k], 0)
                    diag = H[l, k]
                    hgo = hn - go
                    E[l, k] = max(E[l, k] - ge, hgo)
                    h = max(hn, F)
                    F = max(F - ge, hgo)
                    H[l, k] = h
                    m = max(m, h)
                hout[l], fout[l] = H[l, S - 1], F
                diag0[l] = hin
                if l == G - 1:
                    new_scr[j] = (hout[l], fout[l])
                if m > pbest[l][0]:
                    k = int(np.argmax(H[l] == m))
                    pbest[l] = (m, j, base + l * S + k)
        scr = new_scr
        for l in range(G):
            if pbest[l][0] > best[l][0] or (
                    pbest[l][0] == best[l][0] and pbest[l][0] > 0
                    and pbest[l][1] < best[l][1]):
                best[l] = pbest[l]
    score, col, row = min(best, key=lambda b: (-b[0], b[1], b[2]))
    return score, row, col


def _model_case(kind, rng):
    """(prof_aa, prof_ss, t_aa, t_ss, go, ge) int64 profiles of one pair."""
    go, ge = 10, 1
    if kind == "random":
        q, t = _seq(rng, 70), _seq(rng, 45)
    elif kind == "tie_rows":      # the motif twice in the query: two rows tie
        m, n = _seq(rng, 12), _seq(rng, 17)
        q, t = tuple(np.concatenate([a, b, a]) for a, b in zip(m, n)), m
    elif kind == "tie_columns":   # the motif twice in the target
        m, n = _seq(rng, 12), _seq(rng, 9)
        q, t = m, tuple(np.concatenate([a, b, a]) for a, b in zip(m, n))
    elif kind == "tie_across_passes":   # copies 40 rows apart: other pass
        m, n = _seq(rng, 10), _seq(rng, 30)
        q, t = tuple(np.concatenate([a, b, a]) for a, b in zip(m, n)), m
    elif kind == "open_equals_extend":
        q, t, go, ge = _seq(rng, 50), _seq(rng, 40), 2, 2
    elif kind == "free_gaps":
        q, t, go, ge = _seq(rng, 40), _seq(rng, 30), 0, 0
    elif kind == "one_row":
        q, t = _seq(rng, 1), _seq(rng, 20)
    elif kind == "one_column":
        q, t = _seq(rng, 37), _seq(rng, 1)
    else:
        raise ValueError(kind)
    prof = tsw.QueryProfile(*q, comp_bias_correction=False)
    return (prof.prof_aa.astype(np.int64), prof.prof_ss.astype(np.int64),
            t[0], t[1], go, ge)


@pytest.mark.parametrize("G,S", [(4, 8), (8, 8), (8, 16), (16, 16)])
@pytest.mark.parametrize("kind", ["random", "tie_rows", "tie_columns",
                                  "tie_across_passes", "open_equals_extend",
                                  "free_gaps", "one_row", "one_column"])
def test_wavefront_model_matches_scalar_oracle(kind, G, S):
    """The recurrence and the tie rule of csrc/sw.cu (rows in order inside a
    lane, F in a register, per-lane best, one three-key reduction) give the
    score and end positions of `sw_score_endpos_np`, q_end included."""
    rng = np.random.RandomState(len(kind) * 100 + G + S)
    paa, pss, t_aa, t_ss, go, ge = _model_case(kind, rng)
    want = jsw.sw_score_endpos_np(paa, pss, t_aa, t_ss, go, ge)
    got = sw_wavefront_model(paa, pss, t_aa, t_ss, go, ge, G, S)
    assert got == tuple(int(x) for x in want)
    assert want[0] > 0


@pytest.mark.parametrize("G,S", [(4, 8), (8, 24)])
def test_wavefront_model_score_zero_pair(G, S):
    """No positive cell: score 0, q_end = slot length - 1, t_end = 0."""
    paa = np.full((21, 45), -3, dtype=np.int64)
    t = np.arange(30) % 20
    want = jsw.sw_score_endpos_np(paa, paa, t, t)
    assert tuple(want) == (0, 44, 0)
    assert sw_wavefront_model(paa, paa, t, t, 10, 1, G, S) == (0, 44, 0)


# --- launch planning -------------------------------------------------------------

@pytest.mark.parametrize("length,group", [
    (1, (4, 8)), (32, (4, 8)), (33, (8, 8)), (64, (8, 8)), (65, (8, 16)),
    (128, (8, 16)), (129, (8, 24)), (169, (8, 24)), (192, (8, 24)),
    (193, (16, 16)), (256, (16, 16)), (257, (8, 24)), (1500, (8, 24))])
def test_lane_group_follows_slot_length(length, group):
    G, S = tk.sw_lane_group(length)
    assert (G, S) == group
    assert length <= G * S or (length > 256 and group == tk.SW_GROUP_IN_PASSES)
    # no group that holds the slot in one pass has fewer padded rows
    assert all(G * S <= g * s_ for t, (g, s_) in tk.SW_GROUPS if length <= t)


@pytest.mark.parametrize("length,passes", [(192, 1), (256, 1), (385, 3),
                                           (2500, 14)])
def test_plan_passes_and_scratch(length, passes):
    """Slots of unequal length share a launch: each has its own lane group,
    the passes are those of the tallest, the scratch covers every group a
    block can hold."""
    plan = tk.plan_sw_launch([length, 20], [1000, 10], max_tlen=300)
    assert plan["passes"] == passes
    if passes == 1:
        assert plan["scratch"] == 0 and plan["scr_stride"] == 0
    else:   # two values per column of the longest target, for every group
        assert plan["scr_stride"] == 600
        assert plan["scratch"] == (2 * plan["nbx"] * tk.MAX_PAIRS_PER_BLOCK
                                   * 600)
    G, _ = tk.sw_lane_group(length)
    assert plan["nbx"] == min(-(-1000 // (tk.THREADS // G)),
                              tk.TARGET_BLOCKS // 2)


def test_plan_counts_chunks_by_each_slots_group():
    """A 20-row slot packs 32 pairs into a block iteration, a 150-row slot
    16: the blocks per slot follow the slot with the most chunks."""
    assert tk.plan_sw_launch([20, 150], [640, 160], 100)["nbx"] == 20
    assert tk.plan_sw_launch([20, 150], [640, 640], 100)["nbx"] == 40


def test_plan_bounds_the_grid():
    plan = tk.plan_sw_launch([150] * 16, [100_000] * 16, max_tlen=169)
    assert 16 * plan["nbx"] <= tk.TARGET_BLOCKS + 16


@pytest.mark.parametrize("lo,hi,ok", [(-128, 127, True), (0, 0, True),
                                      (-129, 5, False), (-5, 128, False)])
def test_profile_range_check(lo, hi, ok):
    from foldseek_tpu_torch.ops.gapless import check_profile_range
    if ok:
        check_profile_range("profile", lo, hi)
    else:
        with pytest.raises(ValueError):
            check_profile_range("profile", lo, hi)

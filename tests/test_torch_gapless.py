"""The port's gapless prefilter scores (plain PyTorch versions of the CUDA
kernel, run here on CPU tensors) equal the JAX package's Pallas kernels in
interpret mode, exactly: scores are small integers on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldseek_tpu.ops import gapless_pallas as jg
from foldseek_tpu.ops.matrices import mat3di
from foldseek_tpu.search.ungapped import (BYTE_CAP, make_query_profile)
from foldseek_tpu_torch.ops import gapless as tg

import _torch_adapters as ad


def _targets(rng, n, lo, hi, b_pad=None, lt_pad=None):
    seqs = [rng.randint(0, 20, int(rng.randint(lo, hi))).astype(np.int8)
            for _ in range(n)]
    lens = [len(s) for s in seqs]
    return (seqs, jg.prepare_targets_T(seqs, lens, lt_pad=lt_pad, b_pad=b_pad),
            ad.prepare_targets_T(seqs, lens, lt_pad=lt_pad, b_pad=b_pad))


def _profiles(rng, lens, comp_bias=True):
    profs, caps = [], []
    for L in lens:
        p, b = make_query_profile(rng.randint(0, 20, L), comp_bias)
        profs.append(p)
        caps.append(float(BYTE_CAP - b))
    return profs, caps


def _port_stack(profs, caps):
    return [torch.from_numpy(a) for a in tg.pack_profiles_batch(profs, caps)]


def test_prepare_targets_matches():
    rng = np.random.RandomState(0)
    _, jt, tt = _targets(rng, 50, 5, 90)
    assert tt.dtype == np.int8 and np.array_equal(tt, jt)


@pytest.mark.parametrize("seed", [0, 1])
def test_gapless_batch_matches_jax(seed):
    """Mixed query lengths and caps (a low cap saturates real diagonals)."""
    rng = np.random.RandomState(seed)
    profs, caps = _profiles(rng, [33, 90, 8, 121])
    caps[1] = 40.0
    _, jt, tt = _targets(rng, 200, 10, 120, lt_pad=128)
    j_stack, j_caps, lq_pad = jg.pack_profiles_batch(profs, caps)
    want = np.asarray(jg.gapless_scores_batch(
        jnp.asarray(j_stack), jnp.asarray(jt), jnp.asarray(j_caps),
        len(profs), lq_pad))
    got = tg.gapless_scores_batch(*_port_stack(profs, caps),
                                  torch.from_numpy(tt)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want.astype(np.int64))
    assert (want[1] == 40.0).any()   # the cap bound somewhere


def test_gapless_long_matches_jax():
    """K2's contract: a query taller than two 2048-row slabs, byte cap on."""
    rng = np.random.RandomState(5)
    m3 = mat3di(2.0, 0.0)
    Lq = 2 * jg.LONG_QUERY_BLOCK + 517
    prof = m3.scores[:, rng.randint(0, 20, Lq)].astype(np.float32)
    _, jt, tt = _targets(rng, 6, 30, 120)
    want = np.asarray(jg.gapless_scores_long(jg.pack_profile(prof),
                                             jnp.asarray(jt), 225.0))
    got = ad.gapless_scores_long(torch.from_numpy(tg.pack_profile(prof)),
                                 torch.from_numpy(tt), 225).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_topk_tie_order_matches_lax_top_k():
    """A tie-heavy panel (many copies of a few targets): the port's top-k
    keeps the same rows in the same order as lax.top_k, and the host
    lexsort then gives identical candidate lists."""
    rng = np.random.RandomState(3)
    profs, caps = _profiles(rng, [60, 45, 100])
    base = [rng.randint(0, 20, int(rng.randint(40, 100))).astype(np.int8)
            for _ in range(5)]
    seqs = [base[i] for i in rng.randint(0, 5, 384)]
    lens = [len(s) for s in seqs]
    jt = jg.prepare_targets_T(seqs, lens, lt_pad=128)
    tt = ad.prepare_targets_T(seqs, lens, lt_pad=128)
    j_stack, j_caps, lq_pad = jg.pack_profiles_batch(profs, caps)
    k = 37
    j_s, j_i = (np.asarray(x) for x in jg.gapless_topk_batch(
        jnp.asarray(j_stack), jnp.asarray(jt), jnp.asarray(j_caps),
        len(profs), lq_pad, k))
    t_s, t_i = (x.numpy() for x in tg.gapless_topk_batch(
        *_port_stack(profs, caps), torch.from_numpy(tt), k))
    assert np.array_equal(t_s, j_s.astype(np.int64))
    assert np.array_equal(t_i, j_i.astype(np.int64))
    assert len(np.unique(t_s[0])) < k   # ties were there to break
    keys = np.arange(len(seqs), dtype=np.int64)
    for r in range(len(profs)):
        order_t = np.lexsort((keys[t_i[r]], -t_s[r]))
        order_j = np.lexsort((keys[j_i[r]], -j_s[r]))
        assert np.array_equal(t_i[r][order_t], j_i[r][order_j])


def test_gapless_matches_scalar_oracle():
    """Plain version against a per-target numpy column loop (no stacking)."""
    rng = np.random.RandomState(9)
    profs, caps = _profiles(rng, [70, 25], comp_bias=False)
    seqs, _, tt = _targets(rng, 20, 10, 80)
    got = tg.gapless_scores_batch(*_port_stack(profs, caps),
                                  torch.from_numpy(tt)).numpy()
    for q, (p, cap) in enumerate(zip(profs, caps)):
        for b, seq in enumerate(seqs):
            h = np.zeros(p.shape[1], np.int64)
            best = 0
            for c in seq:
                diag = np.concatenate([[0], h[:-1]])
                h = np.minimum(np.maximum(diag + p[c].astype(np.int64), 0),
                               int(cap))
                best = max(best, int(h.max()))
            assert got[q, b] == best


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.RandomState(2)
    profs, caps = _profiles(rng, [20, 30])
    _, _, tt = _targets(rng, 10, 5, 40)
    before = tg.gapless_scores_batch.launches
    args = _port_stack(profs, caps) + [torch.from_numpy(tt)]
    assert torch.equal(tg.gapless_scores_batch(*args),
                       tg.gapless_scores_batch_torch(*args))
    assert tg.gapless_scores_batch.launches == before


def test_pack_profile_rejects_fractional_scores():
    with pytest.raises(ValueError):
        tg.pack_profile(np.full((21, 3), 0.5, np.float32))


@pytest.mark.parametrize("cap", [None, 30.0, 225.0])
def test_gapless_single_matches_jax_and_oracle(cap):
    """K5's contract (one query, one scalar cap or none, 8 targets padded to
    128 as tests/test_prefilter.py does): the adapter over the port's launch
    point equals `gapless_scores_single` in interpret mode, and without a cap
    the numpy oracle `gapless_scores_np`. Exact: all scores are integers."""
    from foldseek_tpu.ops.gapless import gapless_scores_np
    rng = np.random.RandomState(13)
    m3 = mat3di(2.0, 0.0)
    prof = m3.scores[:, rng.randint(0, 20, 77)].astype(np.float32)
    seqs, jt, tt = _targets(rng, 8, 20, 150)
    assert jt.shape[1] == 128
    want = np.asarray(jg.gapless_scores_single(
        jnp.asarray(jg.pack_profile(prof)), jnp.asarray(jt),
        None if cap is None else jnp.float32(cap)))
    got = ad.gapless_scores_single(torch.from_numpy(tg.pack_profile(prof)),
                                   torch.from_numpy(tt), cap).numpy()
    assert got.dtype == np.int32 and got.shape == (128,)
    assert np.array_equal(got, want.astype(np.int64))
    assert not got[8:].any()           # pad targets score 0
    if cap is None:
        zeros = np.zeros_like(prof, dtype=np.int64)
        for i, seq in enumerate(seqs):
            assert got[i] == gapless_scores_np(prof.astype(np.int64), zeros,
                                               seq, np.zeros_like(seq))
    elif cap == 30.0:
        assert (got[:8] == 30).any()   # the cap bound somewhere


def _dual_inputs(rng, lens, n_targets):
    from foldseek_tpu.ops.matrices import blosum62
    m3, mb = mat3di(2.0, 0.0), blosum62()
    profs = [(mb.scores[:, rng.randint(0, 20, L)].astype(np.float32),
              m3.scores[:, rng.randint(0, 20, L)].astype(np.float32))
             for L in lens]
    t_len = rng.randint(15, 120, n_targets)
    aa = [rng.randint(0, 20, L).astype(np.int8) for L in t_len]
    ss = [rng.randint(0, 20, L).astype(np.int8) for L in t_len]
    return profs, aa, ss, t_len


def test_gapless_dual_matches_jax_and_oracle():
    """K6's contract: one query's AA + 3Di profiles against the two panels
    of 8 targets padded to 128; equals `gapless_scores_dual` in interpret
    mode and `gapless_scores_np`. Exact."""
    from foldseek_tpu.ops.gapless import gapless_scores_np
    rng = np.random.RandomState(17)
    [(paa, pss)], aa, ss, t_len = _dual_inputs(rng, [64], 8)
    want = np.asarray(jg.gapless_scores_dual(
        jnp.asarray(jg.pack_profile(paa)), jnp.asarray(jg.pack_profile(pss)),
        jnp.asarray(jg.prepare_targets_T(aa, t_len)),
        jnp.asarray(jg.prepare_targets_T(ss, t_len))))
    got = ad.gapless_scores_dual(
        torch.from_numpy(tg.pack_profile(paa)),
        torch.from_numpy(tg.pack_profile(pss)),
        torch.from_numpy(ad.prepare_targets_T(aa, t_len)),
        torch.from_numpy(ad.prepare_targets_T(ss, t_len))).numpy()
    assert got.dtype == np.int32 and got.shape == (128,)
    assert np.array_equal(got, want.astype(np.int64))
    assert got[:8].min() > 0 and not got[8:].any()
    for i in range(8):
        assert got[i] == gapless_scores_np(paa.astype(np.int64),
                                           pss.astype(np.int64), aa[i], ss[i])


def test_gapless_dual_stack_matches_single_queries():
    """A ragged stack of queries through `gapless_scores_dual` gives each
    query's row as the one-query call does, and the CPU wrapper runs the
    plain version without counting a launch."""
    rng = np.random.RandomState(19)
    profs, aa, ss, t_len = _dual_inputs(rng, [40, 7, 93], 30)
    t_aa = torch.from_numpy(ad.prepare_targets_T(aa, t_len))
    t_ss = torch.from_numpy(ad.prepare_targets_T(ss, t_len))
    stack_aa, q_off, _ = tg.pack_profiles_batch([p for p, _ in profs],
                                                [0] * len(profs))
    stack_ss, _, _ = tg.pack_profiles_batch([p for _, p in profs],
                                            [0] * len(profs))
    before = tg.gapless_scores_dual.launches
    got = tg.gapless_scores_dual(torch.from_numpy(stack_aa),
                                 torch.from_numpy(stack_ss),
                                 torch.from_numpy(q_off), t_aa, t_ss)
    assert tg.gapless_scores_dual.launches == before
    assert got.shape == (3, 128)
    for k, (paa, pss) in enumerate(profs):
        one = ad.gapless_scores_dual(torch.from_numpy(tg.pack_profile(paa)),
                                     torch.from_numpy(tg.pack_profile(pss)),
                                     t_aa, t_ss)
        assert torch.equal(got[k], one)


# --- the kernel's column walk, modelled in numpy --------------------------------

def _s16(x):
    """Wrap to int16 as the packed halves of a register do."""
    return ((np.asarray(x, dtype=np.int64) + 32768) % 65536) - 32768


def gapless_strip_model(prof, cap, t_col, rows, packed):
    """csrc/gapless.cu for one (query, target): a strip of `rows` query rows
    held per pass, updated bottom-up so row k takes the old value of row
    k - 1; packed strips keep (row k, row k + W) in the two int16 halves of a
    register (arithmetic wrapped to int16 here: the precondition must keep
    it from wrapping); passes hand the last row's value per column through
    a scratch row; a pad letter resets the strip; columns beyond the last
    real letter are not walked. prof is [Lq, 32] as `pack_profile` gives."""
    Lq, lt = prof.shape[0], len(t_col)
    letters = np.asarray(t_col).astype(np.int64) & 31
    real = np.nonzero(letters < 21)[0]
    wmax = int(real[-1]) + 1 if len(real) else 0
    W = rows // 2 if packed else rows
    zero = 0 if packed else min(0, cap)
    scr = np.zeros(lt, dtype=np.int64)
    best = 0

    def cell(diag, s):
        if packed:      # __viaddmin_s16x2_relu, one int16 half
            return np.maximum(np.minimum(_s16(diag + s), cap), 0)
        return np.minimum(np.maximum(diag + s, 0), cap)

    for p in range(-(-Lq // rows)):
        base = p * rows
        tile = np.zeros((rows, 21), dtype=np.int64)
        n = min(rows, Lq - base)
        tile[:n] = prof[base:base + n, :21]
        h = np.zeros((rows // W, W), dtype=np.int64)   # [half, register]
        prev = 0
        for j in range(wmax):
            cin = prev
            if p > 0:
                prev = scr[j]
            if letters[j] >= 21:
                h[:] = zero
            else:
                s = tile[:, letters[j]].reshape(h.shape)
                # register 0: the low half takes the pass before, the high
                # half the old low half of the last register
                first = np.array([cin, h[0, W - 1]])[:h.shape[0]]
                diag = np.concatenate([first[:, None], h[:, :-1]], axis=1)
                h = cell(diag, s)
            best = max(best, int(h.max()))
            scr[j] = h[-1, W - 1]
    return best


@pytest.mark.parametrize("rows,packed", [(32, True), (64, True), (192, True),
                                         (32, False)])
@pytest.mark.parametrize("Lq", [20, 32, 33, 150, 193, 400])
def test_strip_model_matches_plain(Lq, rows, packed):
    """One strip, exact strips and passes, capped (packed or not) and
    uncapped (32-bit only): the model of the kernel equals the plain
    version on targets of length 1, of the full padded length, with a pad
    letter in the middle and all pad."""
    rng = np.random.RandomState(Lq + rows)
    prof, b = make_query_profile(rng.randint(0, 20, Lq))
    cap = BYTE_CAP - b if packed else tg.NO_CAP
    lt = 48
    seqs = [rng.randint(0, 20, L).astype(np.int8) for L in (1, lt, 30, 17, 40)]
    tt = ad.prepare_targets_T(seqs, [len(s) for s in seqs], lt_pad=lt, b_pad=8)
    tt[9, 4] = 21            # a pad letter inside a target
    stack = [torch.from_numpy(a)
             for a in tg.pack_profiles_batch([prof], [cap])]
    want = tg.gapless_scores_batch_torch(*stack, torch.from_numpy(tt))[0]
    packed_prof = tg.pack_profile(prof).astype(np.int64)
    for col in range(tt.shape[1]):
        assert gapless_strip_model(packed_prof, int(cap), tt[:, col], rows,
                                   packed) == int(want[col])
    assert int(want.max()) > 0 and int(want[5:].max()) == 0


def test_strip_model_at_the_packed_limits():
    """The largest cap and the widest profile entries `can_pack` admits keep
    every sum inside int16: the wrapped model still equals the plain one."""
    rng = np.random.RandomState(77)
    prof = np.where(rng.rand(21, 300) < 0.05, tg.PROFILE_MIN,
                    tg.PROFILE_MAX).astype(np.float32)
    cap = tg.PACKED_CAP_MAX
    assert tg.can_pack(cap, cap, tg.PROFILE_MIN, tg.PROFILE_MAX, 300, 300)
    seq = rng.randint(0, 20, 300).astype(np.int8)
    tt = ad.prepare_targets_T([seq], [300], lt_pad=300, b_pad=1)
    stack = [torch.from_numpy(a) for a in tg.pack_profiles_batch([prof], [cap])]
    want = int(tg.gapless_scores_batch_torch(*stack, torch.from_numpy(tt))[0, 0])
    assert want == cap       # the running score climbs until the cap binds
    assert gapless_strip_model(tg.pack_profile(prof).astype(np.int64), cap,
                               tt[:, 0], 64, True) == want


# --- launch planning -------------------------------------------------------------

@pytest.mark.parametrize("facts,packed", [
    ((0, 255, -20, 30, 169, 256), True),             # the prefilter's stack
    ((0, tg.PACKED_CAP_MAX, -128, 127, 10**6, 10**6), True),   # the limits
    ((0, tg.PACKED_CAP_MAX + 1, -20, 127, 10**6, 10**6), False),
    # no cap: packed as long as the diagonals are too short to pass 16 bits
    ((0, tg.NO_CAP, -20, 30, 169, 256), True),
    ((0, tg.NO_CAP, -20, 127, 256, 300), True),      # 256 * 127 = 32512
    ((0, tg.NO_CAP, -20, 127, 257, 300), False),
    ((0, tg.NO_CAP, -20, 127, 5000, 256), True),     # the target is the short side
    ((0, tg.NO_CAP, -5, 0, 10**6, 10**6), True),     # nothing ever scores
    ((-1, 200, -20, 30, 100, 100), False),           # a negative cap
    ((0, 255, -129, 30, 100, 100), False), ((0, 255, -20, 128, 100, 100), False)])
def test_can_pack_only_under_the_proven_precondition(facts, packed):
    assert tg.can_pack(*facts) is packed


@pytest.mark.parametrize("length,packed,rows", [
    (0, True, 32), (20, True, 32), (33, True, 64), (96, True, 96),
    (141, True, 160), (169, True, 192), (192, True, 192), (4613, True, 192),
    (32, False, 32), (33, False, 32), (300, False, 32)])
def test_strip_height_follows_query_length(length, packed, rows):
    assert tg.strip_rows(length, packed) == rows
    assert rows in (tg.PACKED_ROWS if packed else tg.WIDE_ROWS)


def test_plan_passes_scratch_and_block_size():
    many = tg.plan_gapless_launch([150] * 16, 65280, 128, packed=True)
    assert many["threads"] == 128 and many["passes"] == 1
    assert many["scratch"] == 0 and many["grid"] == tg.MAX_BLOCKS
    one = tg.plan_gapless_launch([30], 34816, 256, packed=False)
    assert one["threads"] == 32                 # few items: smaller blocks
    assert one["grid"] == min(-(-34816 // 32), tg.MAX_BLOCKS)
    # the packed kernel shares its tile copies among 128 threads
    one = tg.plan_gapless_launch([150], 34816, 256, packed=True)
    assert one["threads"] == 128 and one["grid"] == 34816 // 128
    tall = tg.plan_gapless_launch([4613, 20], 65280, 128, packed=True)
    assert tall["passes"] == -(-4613 // 192)
    assert tall["grid"] <= tg.MAX_BLOCKS_PASSES
    assert tall["scratch"] == tall["grid"] * 128 * tall["threads"]
    assert tg.plan_gapless_launch([97], 500, 64, packed=False)["passes"] == 4
    tiny = tg.plan_gapless_launch([10], 5, 64, packed=False)
    assert tiny["grid"] == 1 and tiny["threads"] == 32


def test_topk_rows_is_the_selection_of_gapless_topk_batch():
    rng = np.random.RandomState(31)
    scores = torch.from_numpy(rng.randint(0, 5, (3, 200)).astype(np.int32))
    s, r = tg.topk_rows(scores, 17)
    for q in range(3):
        order = np.lexsort((np.arange(200), -scores[q].numpy()))[:17]
        assert np.array_equal(r[q].numpy(), order)
        assert np.array_equal(s[q].numpy(), scores[q].numpy()[order])

"""The port's CUDA kernels against their plain PyTorch versions on the card.
Marked `cuda`: each test skips without a CUDA device (a CUDA kernel has no
CPU mode). The file imports nothing of jax, so a GPU machine without jax
runs it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pathlib

import numpy as np
import pytest
import torch

from foldseek_tpu_torch.ops import gapless as tg
from foldseek_tpu_torch.ops import sw_kernels as tk
from foldseek_tpu_torch.ops.sw import QueryProfile
from foldseek_tpu_torch.search.ungapped import BYTE_CAP, make_query_profile
from foldseek_tpu_torch.utils.log import stage_count

import _torch_adapters as ad

GOLDEN = pathlib.Path(__file__).parent / "golden"
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gapless_inputs(rng, lens, n_targets, dev):
    profs, caps = [], []
    for L in lens:
        p, b = make_query_profile(rng.randint(0, 20, L))
        profs.append(p)
        caps.append(BYTE_CAP - b)
    caps[0] = 60   # a cap that binds
    seqs = [rng.randint(0, 20, int(rng.randint(5, 250))).astype(np.int8)
            for _ in range(n_targets)]
    t_T = ad.prepare_targets_T(seqs, [len(s) for s in seqs], lt_pad=256)
    return ([torch.from_numpy(a).to(dev)
             for a in tg.pack_profiles_batch(profs, caps)]
            + [torch.from_numpy(t_T).to(dev)])


@pytest.mark.parametrize("lens", [[150, 3, 97, 160], [4613]])
def test_gapless_kernel_matches_plain(cuda, lens):
    rng = np.random.RandomState(len(lens))
    args = _gapless_inputs(rng, lens, 700, cuda)
    before = stage_count("launches.gapless")
    got = tg.gapless_scores_batch(*args)
    torch.cuda.synchronize()
    assert stage_count("launches.gapless") == before + 1
    assert torch.equal(got, tg.gapless_scores_batch_torch(*args))


def test_gapless_topk_and_long_on_card(cuda):
    rng = np.random.RandomState(3)
    prof, q_off, caps, t_T = _gapless_inputs(rng, [120, 40], 500, cuda)
    s, r = tg.gapless_topk_batch(prof, q_off, caps, t_T, 50)
    s_cpu, r_cpu = tg.gapless_topk_batch(prof.cpu(), q_off.cpu(), caps.cpu(),
                                         t_T.cpu(), 50)
    assert torch.equal(s.cpu(), s_cpu) and torch.equal(r.cpu(), r_cpu)
    one = prof[: int(q_off[1])]
    assert torch.equal(ad.gapless_scores_long(one, t_T, int(caps[0])),
                       tg.gapless_scores_batch_torch(
                           prof, q_off, caps, t_T)[0])


def test_gapless_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.RandomState(4)
    prof, q_off, caps, t_T = _gapless_inputs(rng, [30], 10, cuda)
    with pytest.raises(ValueError):
        tg.gapless_scores_batch(prof, q_off, caps, t_T.to(torch.int32))
    with pytest.raises(ValueError):
        tg.gapless_scores_batch(prof.cpu(), q_off, caps, t_T)


@pytest.mark.parametrize("cap", [None, 30])
def test_gapless_single_shape_on_card(cuda, cap):
    """K5's call shape (one query, one scalar cap or none) through the
    gapless kernel equals the plain version."""
    rng = np.random.RandomState(12)
    prof, _q_off, _caps, t_T = _gapless_inputs(rng, [77], 300, cuda)
    got = ad.gapless_scores_single(prof, t_T, cap)
    torch.cuda.synchronize()
    want = ad.gapless_scores_single(prof.cpu(), t_T.cpu(), cap)
    assert torch.equal(got.cpu(), want)
    if cap is not None:
        assert 0 < int(got.max()) <= cap


@pytest.mark.parametrize("lens", [[64], [40, 7, 93, 300]])
def test_gapless_dual_kernel_matches_plain(cuda, lens):
    """K6: the dual-alphabet kernel, one query and a ragged stack, against
    AA + 3Di panels of 500 targets (pad letter 21 in both)."""
    rng = np.random.RandomState(len(lens))
    profs = [QueryProfile(rng.randint(0, 20, L).astype(np.int8),
                          rng.randint(0, 20, L).astype(np.int8)) for L in lens]
    t_len = rng.randint(5, 250, 500)
    aa = [rng.randint(0, 20, L).astype(np.int8) for L in t_len]
    ss = [rng.randint(0, 20, L).astype(np.int8) for L in t_len]
    stack_aa, q_off, _ = tg.pack_profiles_batch([p.prof_aa for p in profs],
                                                [0] * len(profs))
    stack_ss, _, _ = tg.pack_profiles_batch([p.prof_ss for p in profs],
                                            [0] * len(profs))
    args = [torch.from_numpy(a).to(cuda) for a in (
        stack_aa, stack_ss, q_off, ad.prepare_targets_T(aa, t_len, lt_pad=256),
        ad.prepare_targets_T(ss, t_len, lt_pad=256))]
    before = stage_count("launches.gapless_dual")
    got = tg.gapless_scores_dual(*args)
    torch.cuda.synchronize()
    assert stage_count("launches.gapless_dual") == before + 1
    assert torch.equal(got, tg.gapless_scores_dual_torch(*args))
    assert int(got.max()) > 0 and not got[:, 500:].any()
    with pytest.raises(ValueError):
        tg.gapless_scores_dual(args[0], args[1][:-1], *args[2:])


def _sw_inputs(rng, lens, n_targets, n_cand, dev):
    res = [(rng.randint(0, 20, L).astype(np.int8),
            rng.randint(0, 20, L).astype(np.int8))
           for L in rng.randint(1, 400, n_targets)]
    t_lens = np.array([len(a) for a, _ in res])
    offs = np.concatenate([[0], np.cumsum(t_lens)])
    slots = []
    for L in lens:
        prof = QueryProfile(rng.randint(0, 20, L).astype(np.int8),
                            rng.randint(0, 20, L).astype(np.int8))
        slots += [prof, prof.reversed()]
    paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in slots],
                                          [p.prof_ss for p in slots])
    tids = np.concatenate([rng.choice(n_targets, n_cand, replace=False)
                           for _ in slots])
    return (torch.from_numpy(paa).to(dev), torch.from_numpy(pss).to(dev),
            slot_off, np.arange(len(slots) + 1) * n_cand,
            torch.from_numpy(np.concatenate([a for a, _ in res])).to(dev),
            torch.from_numpy(np.concatenate([s for _, s in res])).to(dev),
            offs[tids], t_lens[tids])


@pytest.mark.parametrize("lens", [[150, 160, 20], [1, 31, 33, 255, 256],
                                  [257, 700], [2500, 90]])
def test_sw_kernel_matches_plain(cuda, lens):
    """Single-tile and multi-tile slots (tiles of up to 256 rows), one-row
    queries and tile-boundary lengths."""
    rng = np.random.RandomState(sum(lens))
    args = _sw_inputs(rng, lens, 300, 120, cuda)
    before = stage_count("launches.sw")
    got = tk.sw_scores_pairs(*args)
    torch.cuda.synchronize()
    assert stage_count("launches.sw") == before + 1
    want = tk.sw_scores_pairs_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sw_batch_multi_and_query_on_card(cuda):
    rng = np.random.RandomState(6)
    S, q, B, Lt = 2, 4, 64, 80
    profs = [QueryProfile(rng.randint(0, 20, L).astype(np.int8),
                          rng.randint(0, 20, L).astype(np.int8))
             for L in rng.randint(10, 300, S * q)]
    paa, pss, so = tk.pack_sw_slots([p.prof_aa for p in profs],
                                    [p.prof_ss for p in profs])
    t_aa = torch.from_numpy(rng.randint(0, 20, (S, B, Lt)).astype(np.int8))
    t_ss = torch.from_numpy(rng.randint(0, 20, (S, B, Lt)).astype(np.int8))
    t_len = torch.from_numpy(rng.randint(0, Lt + 1, (S, B)))
    cpu = ad.sw_scores_batch_multi(torch.from_numpy(paa), torch.from_numpy(pss),
                                   so, t_aa, t_ss, t_len, S, q)
    gpu = ad.sw_scores_batch_multi(torch.from_numpy(paa).to(cuda),
                                   torch.from_numpy(pss).to(cuda), so,
                                   t_aa.to(cuda), t_ss.to(cuda), t_len, S, q)
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.cpu(), c)
    one = ad.sw_scores_query(torch.from_numpy(profs[0].prof_aa).to(cuda),
                             torch.from_numpy(profs[0].prof_ss).to(cuda),
                             t_aa[0].to(cuda), t_ss[0].to(cuda), t_len[0])
    for o, c in zip(one, cpu):
        assert torch.equal(o.cpu(), c[0])


def test_sw_batch_shape_on_card(cuda):
    """K7's call shape: q slots sharing one list of padded targets."""
    rng = np.random.RandomState(9)
    q, B, Lt = 6, 200, 120
    profs = [QueryProfile(rng.randint(0, 20, L).astype(np.int8),
                          rng.randint(0, 20, L).astype(np.int8))
             for L in rng.randint(10, 300, q)]
    paa, pss, so = tk.pack_sw_slots([p.prof_aa for p in profs],
                                    [p.prof_ss for p in profs])
    t_aa = torch.from_numpy(rng.randint(0, 20, (B, Lt)).astype(np.int8))
    t_ss = torch.from_numpy(rng.randint(0, 20, (B, Lt)).astype(np.int8))
    t_len = torch.from_numpy(rng.randint(0, Lt + 1, B))
    cpu = ad.sw_scores_batch(torch.from_numpy(paa), torch.from_numpy(pss), so,
                             t_aa, t_ss, t_len, q)
    gpu = ad.sw_scores_batch(torch.from_numpy(paa).to(cuda),
                             torch.from_numpy(pss).to(cuda), so,
                             t_aa.to(cuda), t_ss.to(cuda), t_len, q)
    for g, c in zip(gpu, cpu):
        assert g.shape == (q, B) and torch.equal(g.cpu(), c)


def _fixture_dbs(tmp_path, n_targets, n_queries):
    from foldseek_tpu_torch.db import create_db, synth_db
    files = ([str(p) for p in sorted((GOLDEN / "msa" / "sup").glob("*.pdb"))]
             + [str(GOLDEN / "d1asha.fcz")])
    base = create_db(files, str(tmp_path / "base"))
    return (synth_db(base, n_targets, str(tmp_path / "t"), seed=1),
            synth_db(base, n_queries, str(tmp_path / "q"), seed=4))


def test_prefilter_split_and_topk_on_card(cuda, tmp_path, monkeypatch):
    """Split streaming and the per-piece device top-k on the card give the
    candidate lists of the whole-panel CPU run."""
    from dataclasses import replace

    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search import ungapped as tung
    tdb, qdb = _fixture_dbs(tmp_path, 1500, 4)
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    params = SearchParams()
    whole = tung.UngappedPrefilter(tdb, torch.device("cpu"))
    want = whole.query_batch(seqs, params)
    split = tung.UngappedPrefilter(tdb, cuda,
                                   budget_bytes=whole.panels.total_bytes // 4)
    assert len(split.panels.splits) >= 3
    assert split.query_batch(seqs, params) == want
    monkeypatch.setattr(tung, "DEVICE_TOPK_MIN_ROWS", 0)
    topk = tung.UngappedPrefilter(tdb, cuda).query_batch(
        seqs, replace(params, max_seqs=40))
    assert topk == [w[:40] for w in want]


@pytest.mark.parametrize("mode", [1, 3])
def test_search_on_card_matches_cpu(cuda, tmp_path, mode, monkeypatch):
    """m8 on cuda == m8 on cpu, for the --gpu 1 path (with the host's
    float64 TM/LDDT gates on both sides: the card's own float32 fleets are
    held to a band in test_search_device_gates_on_card) and for
    --prefilter-mode 3 (3Di-only profiles: ties in the end positions are
    commoner than with two alphabets)."""
    from foldseek_tpu_torch.search import SearchParams, format_results, search
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    tdb, qdb = _fixture_dbs(tmp_path, 1500, 6)
    lines = {}
    for dev in (cuda, torch.device("cpu")):
        params = SearchParams(prefilter_mode=mode, add_backtrace=mode == 1)
        before = stage_count("launches.sw")
        res = search(qdb, tdb, params, dev, same_db=False)
        assert (stage_count("launches.sw") > before) == (dev.type == "cuda")
        lines[dev.type] = format_results(qdb, tdb, res, params.format_output,
                                         with_backtrace=mode == 1)
    assert len(lines["cpu"]) > 1000 and lines["cuda"] == lines["cpu"]


# --- the shapes where the kernels' branches change -----------------------------

def _boundary_panel(rng, dev, n=600, lt=128):
    """A panel whose first target has length 1 and whose second fills the
    padded length; the rest are 1..lt long."""
    lens = rng.randint(1, lt + 1, n)
    lens[0], lens[1] = 1, lt
    seqs = [rng.randint(0, 20, L).astype(np.int8) for L in lens]
    return seqs, torch.from_numpy(
        ad.prepare_targets_T(seqs, lens, lt_pad=lt)).to(dev)


@pytest.mark.parametrize("lens,uncapped", [
    ([31], ()), ([32], ()), ([33], ()), ([96], ()), ([97], ()), ([160], ()),
    ([161], ()), ([192], ()), ([193], ()), ([385], ()), ([97], (0,)),
    ([150, 40], ()), ([150, 40, 20, 200, 100, 70], (1,))])
def test_gapless_boundaries_on_card(cuda, lens, uncapped):
    """Query lengths just below, at and above the strip heights of the packed
    kernel, one and several passes, stacks of unequal queries (each takes
    its own strip) and missing caps that the short diagonals make up for;
    targets of length 1 and of the panel's full padded length."""
    rng = np.random.RandomState(sum(lens) + len(uncapped))
    profs, caps = [], []
    for k, L in enumerate(lens):
        p, b = make_query_profile(rng.randint(0, 20, L))
        profs.append(p)
        caps.append(tg.NO_CAP if k in uncapped else BYTE_CAP - b)
    _, t_T = _boundary_panel(rng, cuda)
    args = [torch.from_numpy(a).to(cuda)
            for a in tg.pack_profiles_batch(profs, caps)] + [t_T]
    hi = int(max(p.max() for p in profs))
    assert tg.can_pack(min(caps), max(caps), -128, hi, max(lens), 128)
    got = tg.gapless_scores_batch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gapless_scores_batch_torch(*args))
    assert int(got[:, :2].min()) >= 0 and int(got.max()) > 0


@pytest.mark.parametrize("lens", [[300], [300, 31, 32, 33, 64, 65, 96, 97]])
def test_gapless_32bit_kernel_on_card(cuda, lens):
    """No cap, profile entries up to 127 and a 300-row query against targets
    up to 384 long: a diagonal can pass 16 bits, so the 32-bit kernel runs,
    queries of 31 to 33 rows in one pass and the taller ones in several."""
    rng = np.random.RandomState(len(lens))
    profs = [rng.randint(-128, 128, (21, L)).astype(np.float32) for L in lens]
    profs[0][:, ::2] = 127               # a query that scores on every target
    assert not tg.can_pack(tg.NO_CAP, tg.NO_CAP, -128, 127, max(lens), 384)
    _, t_T = _boundary_panel(rng, cuda, n=300, lt=384)
    args = [torch.from_numpy(a).to(cuda) for a in tg.pack_profiles_batch(
        profs, [tg.NO_CAP] * len(lens))] + [t_T]
    got = tg.gapless_scores_batch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tg.gapless_scores_batch_torch(*args))
    assert int(got.max()) > 127 * 100


@pytest.mark.parametrize("lens", [[1], [32], [33], [64], [65], [128], [129],
                                  [192], [193], [256], [257], [385],
                                  [20, 1500]])
def test_sw_boundaries_on_card(cuda, lens):
    """Slot lengths around every (G, S) instance and pass boundary, and a
    20-row slot beside a 1,500-row one; targets of length 1 included."""
    rng = np.random.RandomState(sum(lens))
    args = list(_sw_inputs(rng, lens, 300, 100, cuda))
    args[7] = args[7].copy()
    args[7][:3] = 1                      # three pairs whose target is one long
    got = tk.sw_scores_pairs(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, tk.sw_scores_pairs_torch(*args)):
        assert torch.equal(g, w)


def test_sw_plan_on_the_card_matches_plan_on_the_host(cuda):
    """pair_toff / pair_tlen as device tensors (the mode-3 call) give what
    host arrays give, and an all-zero AA profile (the 3Di-only instance)
    equals the plain version."""
    rng = np.random.RandomState(14)
    args = list(_sw_inputs(rng, [150, 60], 300, 120, cuda))
    args[0] = torch.zeros_like(args[0])
    want = tk.sw_scores_pairs_torch(*args)
    on_host = tk.sw_scores_pairs(*args)
    args[6] = torch.from_numpy(args[6]).to(cuda)
    args[7] = torch.from_numpy(args[7]).to(cuda)
    on_card = tk.sw_scores_pairs(*args)
    for a, b, w in zip(on_host, on_card, want):
        assert torch.equal(a, w) and torch.equal(b, w)


def test_wrappers_reject_profiles_outside_int8_on_card(cuda):
    rng = np.random.RandomState(15)
    prof, q_off, caps, t_T = _gapless_inputs(rng, [30], 10, cuda)
    prof = prof.clone()
    prof[3, 5] = 128
    with pytest.raises(ValueError):
        tg.gapless_scores_batch(prof, q_off, caps, t_T)
    args = list(_sw_inputs(rng, [40], 50, 10, cuda))
    args[1] = args[1].clone()
    args[1][2, 7] = -129
    with pytest.raises(ValueError):
        tk.sw_scores_pairs(*args)
    with pytest.raises(ValueError):      # a pair reaching past the residues
        bad = list(args)
        bad[1] = torch.zeros_like(args[1])
        bad[6] = bad[6].copy()
        bad[6][0] = args[4].numel()
        tk.sw_scores_pairs(*bad)


# --- the TM/LDDT gate fleet and the PSSM call shapes ---------------------------

def _walk_pairs(rng, n_pairs, m_pad):
    xa = np.zeros((n_pairs, m_pad, 3), np.float32)
    ya = np.zeros_like(xa)
    m_len = np.zeros(n_pairs, np.int32)
    for p in range(n_pairs):
        n = int(rng.randint(10, m_pad))
        q = np.cumsum(rng.normal(size=(n, 3), scale=2.2), 0)
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot *= np.sign(np.linalg.det(rot))
        xa[p, :n] = q @ rot.T + rng.normal(size=(n, 3), scale=rng.uniform(0.2, 2))
        ya[p, :n], m_len[p] = q, n
    return xa, ya, m_len


@pytest.mark.parametrize("m_pad", [64, 192])
def test_gate_fleet_on_card_matches_cpu(cuda, m_pad):
    """TM and LDDT of the fleet on the card against the same float32 program
    on the CPU, within 1e-5 (the sums are taken in another order), with and
    without the convergence test."""
    from foldseek_tpu_torch.ops.lddt import (batched_lddt_device,
                                             lddt_query_context)
    from foldseek_tpu_torch.ops.tm_device import batched_tm_device
    rng = np.random.RandomState(m_pad)
    xa, ya, m_len = _walk_pairs(rng, 40, m_pad)
    norm = m_len + rng.randint(0, 30, len(m_len))
    cpu = torch.device("cpu")
    want = batched_tm_device(xa, ya, m_len, norm, cpu)
    for check_every in (0, 4):
        got = batched_tm_device(xa, ya, m_len, norm, cuda,
                                check_every=check_every)
        assert np.abs(got - want).max() < 1e-5
    deg = np.zeros(xa.shape[:2], np.float32)
    for p, n in enumerate(m_len):
        deg[p, :n] = lddt_query_context(ya[p, :n])[1]
    got, got_n = batched_lddt_device(ya, xa, deg, m_len, cuda)
    want, want_n = batched_lddt_device(ya, xa, deg, m_len, cpu)
    assert np.array_equal(got_n, want_n) and np.abs(got - want).max() < 1e-5


def test_search_device_gates_on_card(cuda, tmp_path, monkeypatch):
    """The --gpu 1 path with the gate fleets on the card (forced, whatever
    the size) against the host's gates on the CPU: equal hit sets and
    backtraces; TM and LDDT within 2e-3, the structure-bit score within 1
    (float32 fleets against the float64 host engine)."""
    from foldseek_tpu_torch.search import SearchParams, search
    tdb, qdb = _fixture_dbs(tmp_path, 600, 4)
    params = SearchParams(prefilter_mode=1, add_backtrace=True)
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "1")
    before = stage_count("gate_fleets")
    dev = search(qdb, tdb, params, cuda, same_db=False)
    torch.cuda.synchronize()
    assert stage_count("gate_fleets") > before
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    host = search(qdb, tdb, params, torch.device("cpu"), same_db=False)
    n = 0
    for qk, hs in host.items():
        d_by = {r.db_key: r for r in dev[qk]}
        assert set(d_by) == {r.db_key for r in hs}
        for h in hs:
            d = d_by[h.db_key]
            assert d.backtrace == h.backtrace and d.evalue == h.evalue
            assert abs(d.tm - h.tm) < 2e-3 and abs(d.lddt - h.lddt) < 2e-3
            assert abs(d.score - h.score) <= 1
            n += 1
    assert n > 1000


def _pssm_profiles(tmp_path):
    """PSSM query profiles as the profile path builds them, from a first
    search on the CPU."""
    from foldseek_tpu_torch.search import SearchParams, search
    from foldseek_tpu_torch.search.profile import (profile_query,
                                                   result2profile)
    tdb, qdb = _fixture_dbs(tmp_path, 400, 3)
    res = search(qdb, tdb, SearchParams(prefilter_mode=1, add_backtrace=True,
                                        evalue_thr=0.001, max_seqs=60),
                 torch.device("cpu"), same_db=False)
    return tdb, [profile_query(p)
                 for p in result2profile(qdb, tdb, res).values()]


def test_pssm_call_shapes_on_card(cuda, tmp_path):
    """K1 through `query_profile` and K3 through a PSSMQueryProfile pair
    list (forward and column-flipped slots): the card's results equal the
    plain versions' exactly."""
    from foldseek_tpu_torch.db.panels import TorchPanelSet
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search import ungapped as tung
    tdb, qprofs = _pssm_profiles(tmp_path)
    cpu = torch.device("cpu")
    before = stage_count("launches.gapless")
    for qp in qprofs:
        assert not qp.prof_ss[20].any() and qp.prof_ss.min() < 0
        got = tung.UngappedPrefilter(tdb, cuda).query_profile(
            qp.prof_ss, SearchParams())
        want = tung.UngappedPrefilter(tdb, cpu).query_profile(
            qp.prof_ss, SearchParams())
        assert got == want and len(got) > 10
    assert stage_count("launches.gapless") > before
    slots = [p for qp in qprofs for p in (qp, qp.reversed())]
    paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in slots],
                                          [p.prof_ss for p in slots])
    offs = np.asarray(tdb.offsets, dtype=np.int64)
    tids = np.tile(np.arange(200), len(slots))
    pair_start = np.arange(len(slots) + 1) * 200

    def run(dev):
        res_aa, res_ss = TorchPanelSet(tdb, dev).residues()
        return tk.sw_scores_pairs(
            torch.from_numpy(paa).to(dev), torch.from_numpy(pss).to(dev),
            slot_off, pair_start, res_aa, res_ss, offs[tids],
            offs[tids + 1] - offs[tids])
    before = stage_count("launches.sw")
    got = run(cuda)
    torch.cuda.synchronize()
    assert stage_count("launches.sw") == before + 1
    for g, w in zip(got, run(cpu)):
        assert torch.equal(g.cpu(), w)
    assert int(got[0].max()) > 50


# --- the cluster, rbh and multimer workflows on the card -----------------------

def test_cluster_db_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """`cluster_db` (linclust stage and the three-step cascade) on cuda
    equals the same on cpu; its align stages launch the SW kernel. The
    cluster's align runs without TM/LDDT gates, so the results are exact."""
    from foldseek_tpu_torch.cluster.workflow import ClusterParams, cluster_db
    tdb, _ = _fixture_dbs(tmp_path, 300, 1)
    before = stage_count("launches.sw")
    got = cluster_db(tdb, ClusterParams(), cuda)
    torch.cuda.synchronize()
    assert stage_count("launches.sw") > before
    assert got == cluster_db(tdb, ClusterParams(), torch.device("cpu"))
    assert 1 < len(got) < tdb.size


def test_rbh_and_multimer_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """rbh lines and multimer scorecomplex lines on cuda equal those on cpu
    (--gpu 1, TM/LDDT gates forced to the host on both sides)."""
    from foldseek_tpu_torch.multimer.workflow import multimer_search
    from foldseek_tpu_torch.search import SearchParams, format_results
    from foldseek_tpu_torch.search.rbh import rbh
    from foldseek_tpu_torch.db import load_db
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    tdb, qdb = _fixture_dbs(tmp_path, 400, 6)
    for d in (tdb, qdb):   # two-chain complexes, grouped by fileids
        np.save(f"{d.path}/fileids.npy",
                (np.arange(d.size) // 2).astype(np.uint32))
    tdb, qdb = load_db(tdb.path), load_db(qdb.path)
    params = SearchParams(prefilter_mode=1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        before = (stage_count("launches.gapless"), stage_count("launches.sw"))
        res = rbh(qdb, tdb, params, dev)
        out[dev.type, "rbh"] = format_results(qdb, tdb, res,
                                              params.format_output)
        out[dev.type, "multimer"] = multimer_search(qdb, tdb, params, dev)
        after = (stage_count("launches.gapless"), stage_count("launches.sw"))
        assert all(a > b for a, b in zip(after, before)) == (dev.type == "cuda")
    assert out["cuda", "rbh"] == out["cpu", "rbh"] and out["cpu", "rbh"]
    assert out["cuda", "multimer"] == out["cpu", "multimer"]
    assert sum(len(v) for v in out["cpu", "multimer"].values()) >= qdb.size


# --- the index server and the stage verbs on the card -------------------------

def test_index_server_on_card_matches_in_process(cuda, tmp_path, monkeypatch):
    """`serve` on cuda in a thread answers `query_batch` as the in-process
    prefilter on cuda does, with gapless launches; `search --index-server`
    gives the in-process search's m8 (host gates)."""
    import os
    import tempfile
    import threading
    import time

    from foldseek_tpu_torch import server
    from foldseek_tpu_torch.search import SearchParams, format_results
    from foldseek_tpu_torch.search.pipeline import search
    from foldseek_tpu_torch.search.ungapped import UngappedPrefilter
    tdb, qdb = _fixture_dbs(tmp_path, 400, 4)
    sock = os.path.join(tempfile.mkdtemp(prefix="fs"), "s.sock")
    before = stage_count("launches.gapless")
    thread = threading.Thread(target=server.serve,
                              args=(tdb.path, sock, 1000, "cuda"), daemon=True)
    thread.start()
    while not os.path.exists(sock):
        time.sleep(0.1)
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    client = server.IndexServerClient(sock)
    got = client.query_batch(seqs)
    client.close()
    assert stage_count("launches.gapless") > before
    assert got == UngappedPrefilter(tdb, cuda).query_batch(seqs,
                                                           SearchParams())
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    lines = [format_results(qdb, tdb, search(
        qdb, tdb, SearchParams(prefilter_mode=1, add_backtrace=True,
                               index_server=served), cuda, same_db=False),
        SearchParams().format_output, with_backtrace=True)
        for served in (sock, "")]
    client = server.IndexServerClient(sock)
    client.shutdown()
    client.close()
    thread.join(timeout=60)
    assert not os.path.exists(sock)
    assert lines[0] == lines[1] and len(lines[0]) > 20


def test_structurealign_verb_on_card_matches_cpu(cuda, tmp_path):
    """The `structurealign -a` verb over a result DB writes the same bytes
    on cuda as on cpu, and launches the SW kernel on cuda."""
    from foldseek_tpu_torch.cli import main
    tdb, qdb = _fixture_dbs(tmp_path, 300, 3)
    res = str(tmp_path / "res")
    assert main(["search", qdb.path, tdb.path, res, str(tmp_path / "tmp"),
                 "--gpu", "1", "--device", "cpu", "-v", "1"]) == 0
    out = {}
    for dev in ("cuda", "cpu"):
        before = stage_count("launches.sw")
        path = str(tmp_path / f"aln_{dev}")
        assert main(["structurealign", qdb.path, tdb.path, res, path, "-a",
                     "--device", dev, "-v", "1"]) == 0
        torch.cuda.synchronize()
        assert (stage_count("launches.sw") > before) == (dev == "cuda")
        out[dev] = open(path, "rb").read()
    assert out["cuda"] == out["cpu"] and out["cpu"].count(b"\n") > 20


@pytest.mark.parametrize("T", [16, 1000, 4096])
def test_prostt5_bucket_table_on_card_matches_cpu(cuda, T):
    from foldseek_tpu_torch.nn.prostt5 import ProstT5Config, bucket_table
    cfg = ProstT5Config()
    assert torch.equal(bucket_table(T, cfg, cuda).cpu(),
                       bucket_table(T, cfg, "cpu"))


def test_prostt5_on_card_matches_cpu(cuda):
    """The encoder at d_model 256, 4 layers: float32 on the card within 1e-4
    of float32 on the CPU; bfloat16 on the card against float32 on the CPU
    by the margin rule (letters equal wherever the CPU's top-two margin
    exceeds twice the max |Δlogit|)."""
    from foldseek_tpu_torch.nn import prostt5 as P
    cfg = P.ProstT5Config(vocab_size=150, d_model=256, d_kv=32, num_heads=8,
                          d_ff=1024, num_layers=4)
    params = P.init_random_params(cfg, seed=1)
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, 150, (4, 256)))
    mask = torch.zeros(4, 256, dtype=torch.bool)
    for b, n in enumerate((256, 140, 20, 201)):
        mask[b, :n] = True
    valid = torch.zeros(4, 255, dtype=torch.bool)
    for b, n in enumerate((256, 140, 20, 201)):
        valid[b, :n - 2] = True

    def logits(dev, dtype):
        enc = P.ProstT5Encoder(cfg, P.params_from_numpy(cfg, params, dev,
                                                        dtype))
        return enc(tokens.to(dev), mask.to(dev)).cpu()[valid]

    want = logits("cpu", torch.float32)
    assert (logits(cuda, torch.float32) - want).abs().max() <= 1e-4
    got = logits(cuda, torch.bfloat16)
    d = (got - want).abs().max()
    top2 = want.topk(2, -1).values
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & (top2[:, 0] - top2[:, 1] > 2 * d)).any(), d


def test_prostt5_db_search_on_card_matches_cpu(cuda, tmp_path):
    """A DB made by `createdb --prostt5-model` (no C-alpha) searched with
    `search --gpu 1 -a` against a structure DB and against itself, on cuda
    and on cpu: the same m8 bytes. On cuda the gapless kernel launches in
    both searches and the SW kernel in the search against itself (random
    weights' 3Di need not resemble the structures', so against them the
    prefilter may pass no pair)."""
    from foldseek_tpu_torch.cli import main
    from foldseek_tpu_torch.nn import prostt5 as P
    from foldseek_tpu_torch.nn.gguf_writer import write_prostt5_gguf
    tdb, qdb = _fixture_dbs(tmp_path, 300, 3)
    cfg = P.ProstT5Config(vocab_size=150, d_model=256, d_kv=32, num_heads=8,
                          d_ff=1024, num_layers=4)
    gguf = str(tmp_path / "m.gguf")
    write_prostt5_gguf(gguf, cfg, P.init_random_params(cfg, seed=5))
    with open(tmp_path / "q.fasta", "w") as f:
        for i in range(qdb.size):
            f.write(f">{qdb.names[i]}\n{qdb.get_aa_str(i)}\n")
    seq_db = str(tmp_path / "seqdb")
    assert main(["createdb", str(tmp_path / "q.fasta"), seq_db,
                 "--prostt5-model", gguf, "-v", "1"]) == 0
    for target, name in ((tdb.path, "structures"), (seq_db, "self")):
        out = {}
        for dev in ("cuda", "cpu"):
            before = (stage_count("launches.gapless"),
                      stage_count("launches.sw"))
            res = str(tmp_path / f"res_{name}_{dev}")
            assert main(["search", seq_db, target, res, res + "_tmp",
                         "--gpu", "1", "-a", "--device", dev, "-v", "1"]) == 0
            torch.cuda.synchronize()
            gapless = stage_count("launches.gapless") - before[0]
            sw = stage_count("launches.sw") - before[1]
            if dev == "cpu":
                assert (gapless, sw) == (0, 0)
            else:
                assert gapless > 0 and (sw > 0 or name == "structures")
            assert main(["convertalis", seq_db, target, res, res + ".m8",
                         "-v", "1"]) == 0
            out[dev] = open(res + ".m8", "rb").read()
        assert out["cuda"] == out["cpu"], name
    assert out["cpu"].count(b"\n") >= 3


# --- taxonomy, cluster update and the MSA -> profile chain on the card --------

def _taxdump(path, n_species):
    """An NCBI-style taxdump: root -> superkingdom -> phylum -> genus ->
    species, two genera a phylum, `n_species` species spread over them."""
    import os
    os.makedirs(path, exist_ok=True)
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom"), (3, 2, "phylum"),
             (4, 2, "phylum"), (5, 3, "genus"), (6, 3, "genus"),
             (7, 4, "genus"), (8, 4, "genus")]
    species = [100 + i for i in range(n_species)]
    nodes += [(s, 5 + i % 4, "species") for i, s in enumerate(species)]
    with open(os.path.join(path, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes)
    with open(os.path.join(path, "names.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{r} {t}\t|\t\t|\tscientific name\t|\n"
                     for t, _, r in nodes)
    return species


def test_easy_taxonomy_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """easy-taxonomy --gpu 1 (one species per two targets) writes the same
    _lca.tsv, _report and _tophit_aln on cuda as on cpu with the host's
    gates, and launches both kernels on cuda."""
    from foldseek_tpu_torch.cli import main
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    tdb, qdb = _fixture_dbs(tmp_path, 600, 6)
    species = _taxdump(str(tmp_path / "taxdump"), 300)
    with open(tmp_path / "map.tsv", "w") as f:
        f.writelines(f"{tdb.names[i]}\t{species[i // 2]}\n"
                     for i in range(tdb.size))
    assert main(["createtaxdb", tdb.path, "--ncbi-tax-dump",
                 str(tmp_path / "taxdump"), "--tax-mapping-file",
                 str(tmp_path / "map.tsv"), "-v", "1"]) == 0
    out = {}
    for dev in ("cuda", "cpu"):
        before = (stage_count("launches.gapless"),
                  stage_count("launches.sw"))
        prefix = str(tmp_path / dev)
        assert main(["easy-taxonomy", qdb.path, tdb.path, prefix,
                     prefix + "_tmp", "--gpu", "1", "--device", dev,
                     "-v", "1"]) == 0
        torch.cuda.synchronize()
        after = (stage_count("launches.gapless"),
                 stage_count("launches.sw"))
        assert all(a > b for a, b in zip(after, before)) == (dev == "cuda")
        out[dev] = [open(prefix + s, "rb").read()
                    for s in ("_lca.tsv", "_report", "_tophit_aln")]
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][0].count(b"\n") == qdb.size


def test_clusterupdate_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """clusterupdate of a 300-entry clustering to a new version without 30
    entries and with 20 added under names of their own: the same TSV on
    cuda as on cpu; its search and cluster_db launch the SW kernel on
    cuda."""
    from chip_smoke import updated_db
    from foldseek_tpu_torch.cli import main
    from foldseek_tpu_torch.db import load_db, synth_db
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    tdb, _ = _fixture_dbs(tmp_path, 300, 1)
    prefix = str(tmp_path / "old")
    assert main(["easy-cluster", tdb.path, prefix, prefix + "_tmp",
                 "--device", "cpu", "-v", "1"]) == 0
    extra = synth_db(load_db(str(tmp_path / "base")), 20,
                     str(tmp_path / "extra"), seed=7)
    drop = set(np.random.default_rng(0).choice(tdb.size, 30,
                                               replace=False).tolist())
    new = updated_db(tdb, extra, drop, str(tmp_path / "new"))
    out = {}
    for dev in ("cuda", "cpu"):
        before = stage_count("launches.sw")
        path = str(tmp_path / f"new_{dev}.tsv")
        assert main(["clusterupdate", tdb.path, new.path,
                     prefix + "_cluster.tsv", path, str(tmp_path / dev),
                     "--device", dev, "-v", "1"]) == 0
        torch.cuda.synchronize()
        assert (stage_count("launches.sw") > before) == (dev == "cuda")
        out[dev] = open(path, "rb").read()
    assert out["cuda"] == out["cpu"]
    members = sorted(line.split(b"\t")[1] for line in out["cpu"].splitlines())
    assert members == sorted(n.encode() for n in new.names)


def test_msa2profile_search_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """result2msa and msa2profile --seq-db of a search -a, then `search` of
    the profile DB --gpu 1 -a: the same result DB on cuda as on cpu (host
    gates); on cuda the gapless kernel (PSSM shape) and the SW kernel
    launch."""
    from foldseek_tpu_torch.cli import main
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    tdb, qdb = _fixture_dbs(tmp_path, 400, 4)
    d = str(tmp_path)
    assert main(["search", qdb.path, tdb.path, f"{d}/res", f"{d}/tmp",
                 "--gpu", "1", "-a", "--max-seqs", "100", "--device", "cpu",
                 "-v", "1"]) == 0
    assert main(["result2msa", qdb.path, tdb.path, f"{d}/res", f"{d}/msa",
                 "-v", "1"]) == 0
    assert main(["msa2profile", f"{d}/msa", f"{d}/prof", "--seq-db",
                 qdb.path, "-v", "1"]) == 0
    out = {}
    for dev in ("cuda", "cpu"):
        before = (stage_count("launches.gapless"),
                  stage_count("launches.sw"))
        res = f"{d}/pres_{dev}"
        assert main(["search", f"{d}/prof", tdb.path, res, res + "_tmp",
                     "--gpu", "1", "-a", "--device", dev, "-v", "1"]) == 0
        torch.cuda.synchronize()
        after = (stage_count("launches.gapless"),
                 stage_count("launches.sw"))
        assert all(a > b for a, b in zip(after, before)) == (dev == "cuda")
        out[dev] = open(res, "rb").read()
    assert out["cuda"] == out["cpu"] and out["cpu"].count(b"\n") > 100


# --- distribution: ranks of the port's worker on the card ---------------------

def _spawn_ranks(tmp_path, size, args, backend):
    """`size` ranks of `python -m foldseek_tpu_torch.parallel.worker` on
    cuda:0 with `backend`, meeting in a file store; their JSON outputs."""
    import json
    import os
    import subprocess
    import sys
    repo = str(pathlib.Path(__file__).parents[1])
    env = dict(os.environ, OMP_NUM_THREADS="2", FOLDSEEK_TPU_FORK="0",
               FOLDSEEK_TPU_DEVICE_GATES="0",
               PYTHONPATH=os.pathsep.join([repo, os.environ.get(
                   "PYTHONPATH", "")]))
    out = str(tmp_path / f"ranks_{backend}")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "foldseek_tpu_torch.parallel.worker", out,
         *args, "--init-method", f"file://{tmp_path}/store_{backend}",
         "--world-size", str(size), "--rank", str(r), "--device", "cuda:0",
         "--backend", backend, "--timeout", "120"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(size)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(size):
        with open(f"{out}.{r}.json") as f:
            outs.append(json.load(f))
    return outs


def test_distributed_prefilter_nccl_one_rank_on_card(cuda, tmp_path):
    """A 1-rank NCCL world gathers its candidates on the card and gives the
    lists of `UngappedPrefilter` on cuda; the gapless kernel launched."""
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search import ungapped as tung
    tdb, qdb = _fixture_dbs(tmp_path, 1500, 4)
    (rank,) = _spawn_ranks(tmp_path, 1, ["--queries", qdb.path, "--targets",
                                         tdb.path, "--skip-search"], "nccl")
    want = tung.UngappedPrefilter(tdb, cuda).query_batch(
        [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)], SearchParams())
    got = rank["paths"]["prefilter_0"]
    assert got["result"] == [[list(h) for h in q] for q in want]
    assert got["launches"]["gapless"] > 0 and rank["device"] == "cuda:0"


def test_distributed_two_ranks_gloo_on_card(cuda, tmp_path, monkeypatch):
    """Two gloo ranks sharing cuda:0: the sharded prefilter's lists, the long
    query's and distributed_search's m8 equal the single process on cuda
    (host gates), and each rank launched the gapless and the SW kernel."""
    from foldseek_tpu_torch.search import SearchParams, format_results, search
    from foldseek_tpu_torch.search import ungapped as tung
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "0")
    tdb, qdb = _fixture_dbs(tmp_path, 1500, 4)
    ranks = _spawn_ranks(tmp_path, 2, ["--queries", qdb.path, "--targets",
                                       tdb.path, "--max-seqs", "300"], "gloo")
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    single = tung.UngappedPrefilter(tdb, cuda)
    params = SearchParams(max_seqs=300)
    want_pref = [[list(h) for h in q]
                 for q in single.query_batch(seqs, params)]
    want_long = [list(h) for h in single.query(np.concatenate(seqs), params)]
    sparams = SearchParams(prefilter_mode=1, add_backtrace=True, max_seqs=300)
    res = search(qdb, tdb, sparams, cuda, same_db=False)
    want_m8 = "".join(line + "\n" for line in format_results(
        qdb, tdb, res, sparams.format_output, with_backtrace=True))
    for rank in ranks:
        paths = rank["paths"]
        assert paths["prefilter_0"]["result"] == want_pref
        assert paths["long"]["result"] == want_long
        assert paths["search"]["result"] == want_m8 and want_m8
        assert paths["search"]["launches"]["gapless"] > 0
        assert paths["search"]["launches"]["sw"] > 0

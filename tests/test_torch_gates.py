"""The port's TM/LDDT gate fleet (plain PyTorch: ops/tm_device.py,
ops/lddt.py, ops/gates_device.py, the device-gates branch of
search/align.py) against foldseek_tpu's XLA programs and against the host
engines, on the CPU. Inputs are made with numpy from a seed and go to both
packages.

Tolerances. Both fleets are float32 and run the same formulas; on these
inputs they agree to 1e-6 (asserted at 1e-4: a borderline cut set may take
another path when a sum is taken in another order). Against the float64
host engines the bounds are those of tests/test_tm_device.py and
tests/test_device_gates.py: TM and LDDT within 2e-3 (mean TM error below
3e-4), the structure-bit score within 1."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.ops import gates_device as jgates
from foldseek_tpu.ops import lddt as jlddt
from foldseek_tpu.ops import tm_device as jtm
from foldseek_tpu.ops.tmscore import compute_tm_score, kabsch
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipe
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.db.panels import TorchPanelSet
from foldseek_tpu_torch.ops import gates_device as tgates
from foldseek_tpu_torch.ops import lddt as tlddt
from foldseek_tpu_torch.ops import tm_device as ttm
from foldseek_tpu_torch.search import SearchParams
from foldseek_tpu_torch.search import pipeline as tpipe

from _torch_adapters import few_torch_threads, torch_fleet_from_jax

_few_threads = pytest.fixture(autouse=True, scope="module")(
    few_torch_threads)

CPU = torch.device("cpu")
FLEET_TOL = 1e-4       # port fleet vs JAX fleet, both float32
HOST_TOL = 2e-3        # float32 fleet vs float64 host engine
HOST_TM_MEAN = 3e-4


def _rotation(rng):
    a = rng.normal(size=3)
    th = np.linalg.norm(a)
    k = a / max(th, 1e-9)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _random_pairs(seed, n_pairs, m_pad):
    """Random walks and noisy rigid copies: padded x (target), y (query),
    column counts, normalisation lengths, host TM and host LDDT inputs."""
    rng = np.random.default_rng(seed)
    xa = np.zeros((n_pairs, m_pad, 3), np.float32)
    ya = np.zeros((n_pairs, m_pad, 3), np.float32)
    m_len = np.zeros(n_pairs, np.int64)
    norm = np.zeros(n_pairs, np.int64)
    ref = np.zeros(n_pairs)
    for p in range(n_pairs):
        n = int(rng.integers(10, m_pad - 2))
        q = np.cumsum(rng.normal(size=(n, 3), scale=2.2), 0).astype(np.float32)
        t = (q @ _rotation(rng).T.astype(np.float32) + rng.normal(
            size=(n, 3), scale=rng.uniform(0.2, 2.0))).astype(np.float32)
        norm[p] = int(rng.integers(n, n + 30))
        ref[p] = compute_tm_score(q, t, 0, 0, "M" * n, int(norm[p])).tmscore
        xa[p, :n], ya[p, :n], m_len[p] = t, q, n
    return xa, ya, m_len, norm, ref


@pytest.mark.parametrize("m_pad,n_pairs,chunk", [(64, 24, 8), (128, 10, 4)])
def test_batched_tm_matches_jax_and_host(m_pad, n_pairs, chunk):
    xa, ya, m_len, norm, ref = _random_pairs(7, n_pairs, m_pad)
    want = jtm.batched_tm_device(xa, ya, m_len, norm, chunk=chunk)
    got = ttm.batched_tm_device(xa, ya, m_len, norm, CPU, chunk=chunk)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < FLEET_TOL
    assert np.abs(got - ref).max() < HOST_TOL
    assert np.abs(got - ref).mean() < HOST_TM_MEAN


def test_tm_early_stop_equals_all_iterations():
    """A cut set that is a fixed point reproduces itself, so asking every
    iteration, every fourth, or never (all 20 run) gives the same bits."""
    xa, ya, m_len, norm, _ = _random_pairs(3, 16, 64)
    runs = [ttm.batched_tm_device(xa, ya, m_len, norm, CPU, check_every=k)
            for k in (1, 4, 0)]
    assert np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], runs[2])
    assert ttm.default_check_every(CPU) == 1
    assert ttm.default_check_every(torch.device("cuda")) == 4


def test_tm_gapped_backtrace_and_short_alignments():
    """Gapped alignment through the host's index extraction, and alignments
    at the fleet's lower limit of 8 columns."""
    rng = np.random.default_rng(11)
    q = np.cumsum(rng.normal(size=(48, 3), scale=2.0), 0).astype(np.float32)
    t = np.cumsum(rng.normal(size=(52, 3), scale=2.0), 0).astype(np.float32)
    cases = [("M" * 20 + "D" * 4 + "M" * 10 + "I" * 2 + "M" * 14, 2, 1),
             ("M" * 8, 0, 0), ("MMMMDMMMMM", 5, 7)]
    xa = np.zeros((len(cases), 64, 3), np.float32)
    ya = np.zeros_like(xa)
    m_len, ref = [], []
    for p, (bt, qs, ts) in enumerate(cases):
        q_idx, t_idx = jlddt.backtrace_indices(bt, qs, ts)
        xa[p, :len(q_idx)], ya[p, :len(q_idx)] = t[t_idx], q[q_idx]
        m_len.append(len(q_idx))
        ref.append(compute_tm_score(q, t, qs, ts, bt, 48).tmscore)
    norm = np.full(len(cases), 48)
    got = ttm.batched_tm_device(xa, ya, np.array(m_len), norm, CPU)
    want = jtm.batched_tm_device(xa, ya, np.array(m_len), norm, chunk=1)
    assert np.abs(got - want).max() < FLEET_TOL
    assert np.abs(got - np.array(ref)).max() < HOST_TOL


def test_max_eigvec4_matches_eigh():
    """Largest eigenpair of random symmetric traceless 4x4 matrices within
    1e-5 (relative to the eigenvalue) of numpy.linalg.eigh, and the identity
    rotation for an empty subset."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(200, 4, 4))
    A = A + A.transpose(0, 2, 1)
    A -= np.eye(4) * (np.trace(A, axis1=1, axis2=2) / 4)[:, None, None]
    A = (A * rng.uniform(1, 1e4, size=(200, 1, 1))).astype(np.float32)
    w, v = np.linalg.eigh(A.astype(np.float64))
    # Newton starts from an upper bound of lambda_max; Horn's (G1 + G2) / 2
    # lies close above it, here up to 30 %
    lam0 = (w[:, -1] * rng.uniform(1.0, 1.3, size=200)).astype(np.float32)
    lam, q = ttm._max_eigvec4(torch.from_numpy(A), torch.from_numpy(lam0))
    lam_j, q_j = jtm._max_eigvec4(A, lam0)
    # Newton converges quadratically only to a simple root: hold the cases
    # whose two largest eigenvalues lie at least 1 % apart
    gap_ok = (w[:, -1] - w[:, -2]) > 1e-2 * w[:, -1]
    assert gap_ok.sum() > 150
    assert np.abs(lam.numpy() / w[:, -1] - 1)[gap_ok].max() < 1e-5
    dots = np.abs((q.numpy() * v[:, :, -1]).sum(-1))
    assert (1 - dots[gap_ok]).max() < 1e-5
    assert np.abs(lam.numpy() - np.asarray(lam_j)).max() \
        <= 1e-5 * np.abs(w[:, -1]).max()
    # an empty subset (all sums zero): the identity rotation, as in JAX
    _, q0 = ttm._max_eigvec4(torch.zeros(1, 4, 4), torch.zeros(1))
    _, q0_j = jtm._max_eigvec4(np.zeros((1, 4, 4), np.float32),
                               np.zeros(1, np.float32))
    assert np.array_equal(np.abs(q0.numpy()), np.abs(np.asarray(q0_j)))
    assert np.abs(q0.numpy()).tolist() == [[1.0, 0.0, 0.0, 0.0]]


def test_horn_masked_batch_matches_kabsch():
    """Rotations and translations of masked subsets within 1e-5 (rotation
    entries) of the host's SVD Kabsch, and equal to the JAX function's."""
    rng = np.random.default_rng(9)
    P, S, M = 3, 5, 40
    x = np.cumsum(rng.normal(size=(P, M, 3), scale=2.0), 1).astype(np.float32)
    y = np.stack([x[p] @ _rotation(rng).T + rng.normal(size=3) * 5
                  + rng.normal(size=(M, 3), scale=0.3) for p in range(P)])
    y = y.astype(np.float32)
    w = (rng.random((P, S, M)) < 0.5).astype(np.float32)
    w[:, 0] = 1.0
    R, t = ttm._horn_masked_batch(*(torch.from_numpy(a) for a in (x, y, w)))
    for p in range(P):
        Rj, tj = jtm._horn_masked_batch(x[p], y[p], w[p])
        assert np.abs(R[p].numpy() - np.asarray(Rj)).max() < 1e-5
        assert np.abs(t[p].numpy() - np.asarray(tj)).max() < 1e-3
        for s in range(S):
            sel = w[p, s] > 0
            Rk, tk, _ = kabsch(x[p][sel].astype(np.float64),
                               y[p][sel].astype(np.float64))
            assert np.abs(R[p, s].numpy() - Rk).max() < 1e-5
            assert np.abs(t[p, s].numpy() - tk).max() < 1e-3


@pytest.mark.parametrize("m_pad", [64, 128, 192, 256, 1024])
def test_fragment_slots_cover_the_full_grid(m_pad):
    """The slot grid without duplicates seeds the same (length, start)
    fragments as the full 6 x s_max grid of the XLA program, for every
    alignment length of the bucket."""
    li, sj = ttm.fragment_slots(m_pad)
    s_max = max(1, (m_pad - 1) // ttm.SIMPLIFY_STEP + 2)
    assert len(li) <= 6 * s_max
    for l_ali in range(1, m_pad + 1):
        l_min = min(4, l_ali)

        def frags(levels, starts):
            out = set()
            for lv, s in zip(levels, starts):
                lf = l_min if lv >= 5 else max(l_ali >> lv, l_min)
                out.add((lf, min(ttm.SIMPLIFY_STEP * s, l_ali - lf)))
            return out
        full = frags(np.repeat(np.arange(6), s_max),
                     np.tile(np.arange(s_max), 6))
        assert frags(li.tolist(), sj.tolist()) == full, l_ali


def _lddt_inputs(seed, n_pairs, m_pad):
    rng = np.random.default_rng(seed)
    qa = np.zeros((n_pairs, m_pad, 3), np.float32)
    ta = np.zeros_like(qa)
    deg = np.zeros((n_pairs, m_pad), np.float32)
    m_len = np.zeros(n_pairs, np.int32)
    ref = np.zeros(n_pairs)
    for p in range(n_pairs):
        n = int(rng.integers(12, m_pad))
        q = np.cumsum(rng.normal(size=(n, 3), scale=2.2), 0).astype(np.float32)
        t = (q @ _rotation(rng).T.astype(np.float32) + rng.normal(
            size=(n, 3), scale=rng.uniform(0.1, 1.5))).astype(np.float32)
        ctx = jlddt.lddt_query_context(q)
        ref[p] = jlddt.compute_lddt(q, t, 0, 0, "M" * n, q_ctx=ctx).avg_lddt
        qa[p, :n], ta[p, :n], deg[p, :n], m_len[p] = q, t, ctx[1], n
    return qa, ta, deg, m_len, ref


def test_batched_lddt_matches_jax_and_host():
    qa, ta, deg, m_len, ref = _lddt_inputs(2, 20, 64)
    want, want_n = jlddt.batched_lddt_device(qa, ta, deg, m_len, chunk=8)
    got, got_n = tlddt.batched_lddt_device(qa, ta, deg, m_len, CPU, chunk=8)
    assert got.dtype == np.float32 and got_n.dtype == np.int32
    assert np.array_equal(got_n, want_n)
    assert np.abs(got - want).max() < FLEET_TOL
    assert np.abs(got - ref).max() < HOST_TOL
    assert tlddt.lddt_chunk_for(64) >= 8 and ttm.tm_chunk_for(64) >= 8


@pytest.mark.parametrize("need_tm,need_lddt", [(True, True), (True, False),
                                               (False, True)])
def test_gate_fleet_matches_jax(need_tm, need_lddt):
    """A whole fleet through both packages' fused programs: the same
    panels, gather indices, lengths and normalisations in; [3, P] out."""
    rng = np.random.default_rng(21)
    n_t, n_q, m_pad, P = 30, 3, 64, 37
    q_lens = rng.integers(40, 90, n_q)
    t_lens = q_lens[np.arange(n_t) % n_q]
    t_off = np.concatenate([[0], np.cumsum(t_lens)])
    q_off = np.concatenate([[0], np.cumsum(q_lens)])
    q_coords = np.concatenate([np.cumsum(rng.normal(size=(n, 3), scale=2.2), 0)
                               for n in q_lens]).astype(np.float32)
    q_deg = np.concatenate([jlddt.lddt_query_context(
        q_coords[q_off[i]:q_off[i + 1]])[1] for i in range(n_q)]
    ).astype(np.float32)
    # target ti: a noisy rigid copy of query ti % n_q
    t_panel = np.concatenate([
        q_coords[q_off[ti % n_q]:q_off[ti % n_q + 1]] @ _rotation(rng).T
        + rng.normal(size=(t_lens[ti], 3), scale=rng.uniform(0.3, 1.5))
        for ti in range(n_t)]).astype(np.float32)
    jfleet = jgates.GateFleet(m_pad, P, need_tm, need_lddt)
    for p in range(P):
        ti = int(rng.integers(n_t))
        qi = ti % n_q
        m = int(rng.integers(8, min(q_lens[qi], m_pad)))
        start = int(rng.integers(0, q_lens[qi] - m + 1))
        jfleet.qabs[p, :m] = q_off[qi] + start + np.arange(m)
        jfleet.tabs[p, :m] = t_off[ti] + start + np.arange(m)
        jfleet.m_len[p] = m
        jfleet.norm[p] = q_lens[qi]
    tfleet = torch_fleet_from_jax(jfleet)
    import jax.numpy as jnp
    jfleet.dispatch(jnp.asarray(t_panel), jnp.asarray(q_coords),
                    jnp.asarray(q_deg))
    before = tgates.GateFleet.dispatches
    tfleet.dispatch(*(torch.from_numpy(a) for a in (t_panel, q_coords, q_deg)))
    assert tgates.GateFleet.dispatches == before + 1
    for got, want in zip(tfleet.result(), jfleet.result()):
        assert got.shape == (P,)
        assert np.abs(got - want).max() < FLEET_TOL
    if need_tm:
        assert tfleet.result()[0].max() > 0.3


def _fixture_inputs(golden_dir):
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """The 17-entry fixture DB expanded to 80 targets and 5 queries."""
    d = tmp_path_factory.mktemp("torch_gates")
    base = create_db(_fixture_inputs(golden_dir), str(d / "base"))
    synth_db(base, 80, str(d / "t80"), seed=1)
    synth_db(base, 5, str(d / "q5"), seed=4)
    dirs = (str(d / "t80"), str(d / "q5"))
    return ([jstorage.load_db(p) for p in dirs],
            [tdbmod.load_db(p) for p in dirs])


def _records(results):
    return {(int(qk), r.db_key): r for qk, rs in results.items() for r in rs}


@pytest.fixture(scope="module")
def host_results(dbs):
    """Both packages' searches with the host gates (they are byte-equal)."""
    (jt, jq), (tt, tq) = dbs
    kw = dict(prefilter_mode=1, add_backtrace=True)
    want = jpipe.search(jq, jt, jparams.SearchParams(**kw), same_db=False)
    mine = tpipe.search(tq, tt, SearchParams(**kw), CPU, same_db=False)
    return _records(want), _records(mine)


@pytest.mark.parametrize("panel", ["resident", "union"])
def test_search_with_device_gates_on_cpu(dbs, host_results, panel,
                                         monkeypatch):
    """FOLDSEEK_TPU_DEVICE_GATES=1 on --device cpu: the hit set, the
    backtraces and every integer column but the scaled score equal the host
    gates' of both packages; TM, LDDT and the score lie inside the band."""
    _, (tt, tq) = dbs
    jhost, thost = host_results
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "1")
    if panel == "union":
        monkeypatch.setattr(TorchPanelSet, "ca", lambda self: None)
    before = tgates.GateFleet.dispatches
    dev = _records(tpipe.search(
        tq, tt, SearchParams(prefilter_mode=1, add_backtrace=True), CPU,
        same_db=False))
    assert tgates.GateFleet.dispatches > before
    assert len(dev) > 150 and set(dev) == set(thost) == set(jhost)
    for key, d in dev.items():
        for h in (thost[key], jhost[key]):
            assert (d.backtrace, d.q_start, d.q_end, d.t_start, d.t_end,
                    d.identical, d.aln_length, d.evalue) == (
                h.backtrace, h.q_start, h.q_end, h.t_start, h.t_end,
                h.identical, h.aln_length, h.evalue)
            assert abs(d.tm - h.tm) < HOST_TOL, (key, d.tm, h.tm)
            assert abs(d.lddt - h.lddt) < HOST_TOL, (key, d.lddt, h.lddt)
            assert abs(d.score - h.score) <= 1, (key, d.score, h.score)


def test_device_gates_env_and_threshold(dbs, monkeypatch):
    """=0 forces the host, =1 the fleets; unset, the CPU keeps the host
    whatever the size (DEVICE_GATES_MIN_PAIRS is the card's threshold)."""
    from foldseek_tpu_torch.search import align as talign
    _, (tt, tq) = dbs
    params = SearchParams(prefilter_mode=1, add_backtrace=True)
    assert talign.DEVICE_GATES_MIN_PAIRS == 8192
    monkeypatch.setattr(talign, "DEVICE_GATES_MIN_PAIRS", 1)
    for env, want_fleets in (("0", False), (None, False), ("1", True)):
        if env is None:
            monkeypatch.delenv("FOLDSEEK_TPU_DEVICE_GATES", raising=False)
        else:
            monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", env)
        before = tgates.GateFleet.dispatches
        tpipe.search(tq, tt, replace(params, max_seqs=10), CPU, same_db=False)
        assert (tgates.GateFleet.dispatches > before) == want_fleets, env
    # thresholds on TM make the accept loop depend on the gates: no fleets
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "1")
    before = tgates.GateFleet.dispatches
    tpipe.search(tq, tt, replace(params, max_seqs=10, tmscore_threshold=0.2),
                 CPU, same_db=False)
    assert tgates.GateFleet.dispatches == before


def test_ca_panel_is_made_once_and_holds_the_db(dbs):
    _, (tt, _) = dbs
    panels = TorchPanelSet(tt, CPU)
    ca = panels.ca()
    assert panels.ca() is ca and panels._buckets is None
    assert ca.dtype == torch.float32 and tuple(ca.shape) == (tt.total_residues, 3)
    assert np.array_equal(ca.numpy(), np.asarray(tt.ca, np.float32))

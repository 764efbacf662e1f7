"""Profile and iterative search of the port (search/profile.py,
`UngappedPrefilter.query_profile`, `align_all(query_profiles=)`,
`profile_search`, `iterative_search`, the CLI) against foldseek_tpu on the
fixture synth DB. Integer profiles, candidate lists and m8 bytes: all exact.
The PSSM probabilities are float32 arrays computed by the same numpy code
and are compared exactly as well."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foldseek_tpu.search import convertalis as jconv
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipe
from foldseek_tpu.search import profile as jprofile
from foldseek_tpu.search import ungapped as jung
from foldseek_tpu_torch.ops import gapless as tgapless
from foldseek_tpu_torch.ops import sw_kernels as tswk
from foldseek_tpu_torch.search import SearchParams, format_results
from foldseek_tpu_torch.search import align as talign
from foldseek_tpu_torch.search import pipeline as tpipe
from foldseek_tpu_torch.search import profile as tprofile
from foldseek_tpu_torch.search import ungapped as tung

from _torch_adapters import few_torch_threads, make_fixture_dbs

_few_threads = pytest.fixture(autouse=True, scope="module")(
    few_torch_threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
M8 = SearchParams().format_output


@pytest.fixture(autouse=True)
def _sequential_prefilter(monkeypatch):
    """This process holds a live JAX client beside the port: keep the
    port's k-mer prefilter from forking it."""
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    return make_fixture_dbs(golden_dir, tmp_path_factory.mktemp("torch_iter"),
                            100, 3)


@pytest.fixture(scope="module")
def profiles(dbs):
    """Each package's profiles from its own first-round search at the
    iterative workflow's non-final E-value gate."""
    (jt, jq), (tt, tq) = dbs
    kw = dict(prefilter_mode=1, add_backtrace=True, evalue_thr=0.001)
    jres = jpipe.search(jq, jt, jparams.SearchParams(**kw), same_db=False)
    tres = tpipe.search(tq, tt, SearchParams(**kw), CPU, same_db=False)
    return (jprofile.result2profile(jq, jt, jres),
            tprofile.result2profile(tq, tt, tres))


def test_result2profile_pssm_equal(profiles):
    """Probabilities, consensus, stored PSSM bytes and the alignment-scale
    integer profiles (stored / 4, truncated; X row 0) are equal, and the
    integer profiles lie in the range the CUDA kernels take."""
    jprofs, tprofs = profiles
    assert set(jprofs) == set(tprofs) and len(tprofs) == 3
    for key, jp in jprofs.items():
        tp = tprofs[key]
        for name in ("prob_aa", "prob_ss", "consensus_aa", "consensus_ss"):
            assert np.array_equal(getattr(jp, name), getattr(tp, name)), name
        jq_, tq_ = jprofile.profile_query(jp), tprofile.profile_query(tp)
        for name in ("prof_aa", "prof_ss", "q_aa", "q_ss"):
            assert np.array_equal(getattr(jq_, name), getattr(tq_, name)), name
        assert tq_.prof_ss.dtype == np.int32 and tq_.prof_ss.shape[0] == 21
        assert not tq_.prof_ss[20].any() and not tq_.prof_aa[20].any()
        for prof in (tq_.prof_aa, tq_.prof_ss):
            assert tgapless.PROFILE_MIN <= prof.min() and \
                prof.max() <= tgapless.PROFILE_MAX
        rev = tq_.reversed()
        assert np.array_equal(rev.prof_ss, tq_.prof_ss[:, ::-1])
        assert np.array_equal(rev.prof_aa, jq_.reversed().prof_aa)


def test_query_profile_lists_match_jax(dbs, profiles, monkeypatch):
    """`UngappedPrefilter.query_profile` with the 3Di PSSM: (key, score)
    lists equal to foldseek_tpu's; the PSSM's own range decides whether the
    packed 16-bit kernel may run."""
    (jt, _), (tt, _) = dbs
    jprofs, tprofs = profiles
    jpref = jung.UngappedPrefilter(jt)
    tpref = tung.UngappedPrefilter(tt, CPU)
    seen = []
    real = tung.make_profile_stacks
    monkeypatch.setattr(
        tung, "make_profile_stacks",
        lambda profs, biases, dev: seen.append((profs, biases)) or
        real(profs, biases, dev))
    for key in tprofs:
        want = jpref.query_profile(jprofile.profile_query(jprofs[key]).prof_ss,
                                   jparams.SearchParams())
        prof = tprofile.profile_query(tprofs[key]).prof_ss
        got = tpref.query_profile(prof, SearchParams())
        assert got == want and len(got) > 10
        (profs, biases), = seen[-1:]
        assert biases == [abs(min(int(prof.min()), 0))]
        assert tpref.query_profiles([prof, prof], SearchParams()) == [got, got]
        cap = tung.BYTE_CAP - biases[0]
        assert tgapless.can_pack(cap, cap, int(prof.min()), int(prof.max()),
                                 prof.shape[1], 256)


def test_pair_scorer_takes_prebuilt_profiles(dbs, profiles):
    """`PairScorer` with PSSM profiles: the slots that reach
    `sw_scores_pairs` are the profiles and their column-flipped reversals as
    they come, and the scores equal foldseek_tpu's scan."""
    from foldseek_tpu.search import align as jalign
    (jt, jq), (tt, tq) = dbs
    jprofs, tprofs = profiles
    jqp = {k: jprofile.profile_query(p) for k, p in jprofs.items()}
    tqp = {k: tprofile.profile_query(p) for k, p in tprofs.items()}
    pref = {k: [int(x) for x in tt.keys[:25]] for k in tqp}
    want = jalign.PairScorer(jprofile.ProfileQueryDB(jprofs), jt,
                             jparams.SearchParams(), pref,
                             jq.key_to_index(), jt.key_to_index(),
                             query_profiles=jqp)
    got = talign.PairScorer(tprofile.ProfileQueryDB(tprofs), tt,
                            SearchParams(), pref, tq.key_to_index(),
                            tt.key_to_index(), CPU, query_profiles=tqp)
    for k in pref:
        assert got.profs[k] is tqp[k]
        assert not talign.use_block_aligner(got.profs[k])
        for a, b in zip(got.per_query[k], want.per_query[k]):
            assert np.array_equal(a, b)


def _m8(side, results, fmt, qdb=None):
    tdb, q = side
    return fmt(qdb if qdb is not None else q, tdb, results, M8,
               with_backtrace=True)


def test_profile_search_m8_matches_jax(dbs, profiles):
    (jt, jq), (tt, tq) = dbs
    jprofs, tprofs = profiles
    kw = dict(add_backtrace=True)
    want = jpipe.profile_search(jprofs, jt, jparams.SearchParams(**kw))
    got = tpipe.profile_search(tprofs, tt, SearchParams(**kw), CPU)
    w = _m8((jt, jq), want, jconv.format_results,
            jprofile.ProfileQueryDB(jprofs))
    g = _m8((tt, tq), got, format_results, tprofile.ProfileQueryDB(tprofs))
    assert len(w) > 100 and g == w


@pytest.mark.parametrize("prefilter_mode", [0, 1])
@pytest.mark.parametrize("n_iter", [2, 3])
def test_iterative_search_m8_matches_jax(dbs, n_iter, prefilter_mode):
    (jt, jq), (tt, tq) = dbs
    kw = dict(prefilter_mode=prefilter_mode, add_backtrace=True)
    want = jpipe.iterative_search(jq, jt, jparams.SearchParams(**kw), n_iter,
                                  same_db=False)
    got = tpipe.iterative_search(tq, tt, SearchParams(**kw), n_iter, CPU,
                                 same_db=False)
    w = _m8((jt, jq), want, jconv.format_results)
    g = _m8((tt, tq), got, format_results)
    first = tpipe.search(tq, tt, SearchParams(**kw, evalue_thr=0.001), CPU,
                         same_db=False)
    assert g == w
    # the profile rounds found hits the first round did not
    assert len(w) > sum(len(v) for v in first.values()) > 50


def test_iterative_search_resumes_from_aln_iter1(dbs, tmp_path, monkeypatch):
    """With a tmp dir each iteration's merged alignments persist under
    `aln_iter{n}`; a second run reads them back and aligns nothing."""
    _, (tt, tq) = dbs
    params = SearchParams(prefilter_mode=1, add_backtrace=True)
    first = tpipe.iterative_search(tq, tt, params, 2, CPU, same_db=False,
                                   tmp_dir=str(tmp_path))
    assert list(tmp_path.rglob("aln_iter1*"))
    assert not list(tmp_path.rglob("aln_iter2*"))
    monkeypatch.setattr(tpipe, "align_all",
                        lambda *a, **k: pytest.fail("stage ran again"))
    again = tpipe.iterative_search(tq, tt, params, 2, CPU, same_db=False,
                                   tmp_dir=str(tmp_path))
    assert _m8((tt, tq), again, format_results) == \
        _m8((tt, tq), first, format_results)


def test_iterative_launches_go_through_the_kernel_wrappers(dbs, monkeypatch):
    """Iterative search in mode 1 scores every round through the two launch
    points: one gapless call a bucket and round (the profile queries of a
    round form one stack), one SW call a round."""
    _, (tt, tq) = dbs
    calls = {"gapless": 0, "sw": 0}
    real_g, real_s = tung.gapless_scores_batch, talign.sw_scores_pairs

    def gapless(*a, **k):
        calls["gapless"] += 1
        return real_g(*a, **k)

    def sw(*a, **k):
        calls["sw"] += 1
        return real_s(*a, **k)
    monkeypatch.setattr(tung, "gapless_scores_batch", gapless)
    monkeypatch.setattr(talign, "sw_scores_pairs", sw)
    tpipe.iterative_search(tq, tt, SearchParams(prefilter_mode=1), 2, CPU,
                           same_db=False)
    n_buckets = len(tung.resident_prefilter(tt, CPU).panels.buckets)
    assert calls == {"gapless": n_buckets * 2, "sw": 2}
    assert tswk.sw_scores_pairs is real_s


def _run_port_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, FOLDSEEK_TPU_FORK="0")
    return subprocess.run([sys.executable, "-m", "foldseek_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_iterative_and_profile_db(dbs, profiles, tmp_path):
    """`easy-search --num-iterations 2` with no prefilter flag (mode 0) and
    the `search` verb on a profile DB, in subprocesses, against
    foldseek_tpu's easy_search and profile_search."""
    from foldseek_tpu.search.resultdb import read_result_db
    (jt, jq), (tt, tq) = dbs
    proc = _run_port_cli(["easy-search", tq.path, tt.path,
                          str(tmp_path / "port.m8"), str(tmp_path / "tmp_port"),
                          "--num-iterations", "2", "--device", "cpu", "-v", "1"],
                         cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    want = jpipe.easy_search(jq.path, jt.path, str(tmp_path / "jax.m8"),
                             str(tmp_path / "tmp_jax"),
                             jparams.SearchParams(num_iterations=2))
    assert len(want) > 100
    assert (tmp_path / "port.m8").read_text() == \
        (tmp_path / "jax.m8").read_text()

    jprofs, tprofs = profiles
    tprofile.save_profile_db(tprofs, str(tmp_path / "profdb"))
    assert tprofile.is_profile_db(str(tmp_path / "profdb"))
    proc = _run_port_cli(["search", str(tmp_path / "profdb"), tt.path,
                          str(tmp_path / "res"), str(tmp_path / "tmp2"),
                          "--device", "cpu", "-a", "-v", "1"],
                         cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    got, has_bt = read_result_db(str(tmp_path / "res"))
    want = jpipe.profile_search(jprofs, jt,
                                jparams.SearchParams(add_backtrace=True))
    assert has_bt and set(got) == set(want)
    for key in want:
        assert [(r.db_key, r.score, r.backtrace) for r in got[key]] == \
            [(r.db_key, r.score, r.backtrace) for r in want[key]]

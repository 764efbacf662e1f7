"""The port's k-mer prefilter (search/kmer.py, db/index.py: numpy and the
native library, copied with the imports rewritten) against foldseek_tpu's on
the fixture DB: the same candidate lists in the same order, for sequence
queries and for PSSM queries. Everything here is integer work, so the
comparison is exact."""
import shutil

import numpy as np
import pytest

from foldseek_tpu.db import index as jindex
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.ops.matrices import mat3di as jmat3di
from foldseek_tpu.search import kmer as jkmer
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipe
from foldseek_tpu.search import profile as jprofile
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.db import index as tindex
from foldseek_tpu_torch.ops.matrices import mat3di
from foldseek_tpu_torch.search import SearchParams
from foldseek_tpu_torch.search import kmer as tkmer
from foldseek_tpu_torch.search import profile as tprofile
from foldseek_tpu_torch.search.prefilter import run_prefilter

from _torch_adapters import few_torch_threads, make_fixture_dbs

_few_threads = pytest.fixture(autouse=True, scope="module")(
    few_torch_threads)


@pytest.fixture(autouse=True)
def _sequential_prefilter(monkeypatch):
    """This process holds a live JAX client beside the port (only the tests
    import both): keep the port's prefilter from forking it."""
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """name -> ((jax targets, jax queries), (port targets, port queries)):
    the 17 fixture entries themselves, and 150 synthetic targets."""
    d = tmp_path_factory.mktemp("torch_kmer")
    return {"base17": make_fixture_dbs(golden_dir, d / "a", 0, 4),
            "synth150": make_fixture_dbs(golden_dir, d / "b", 150, 4)}


@pytest.mark.parametrize("k", [6, 7])
@pytest.mark.parametrize("which", ["base17", "synth150"])
def test_kmer_prefilter_candidates_match_jax(dbs, which, k):
    (jt, jq), (tt, tq) = dbs[which]
    want = jkmer.kmer_prefilter(jq, jt, jparams.SearchParams(), k=k)
    got = tkmer.kmer_prefilter(tq, tt, SearchParams(), k=k)
    assert got == want
    assert sum(len(v) for v in want.values()) >= 4 * 3


def test_run_prefilter_mode0_is_the_kmer_prefilter(dbs):
    """`run_prefilter` with the default mode dispatches to the k-mer
    prefilter with the parameters' k-mer size (0: chosen from the DB)."""
    import torch
    (jt, jq), (tt, tq) = dbs["synth150"]
    from foldseek_tpu.search.prefilter import run_prefilter as jrun
    want = jrun(jq, jt, jparams.SearchParams())
    got = run_prefilter(tq, tt, SearchParams(), torch.device("cpu"))
    assert SearchParams().prefilter_mode == 0 and got == want
    assert list(got) == [int(k) for k in tq.keys]


@pytest.fixture(scope="module")
def profiles(dbs):
    """Each package's profiles from its own first-round search."""
    import torch
    from foldseek_tpu_torch.search import pipeline as tpipe
    (jt, jq), (tt, tq) = dbs["synth150"]
    kw = dict(prefilter_mode=1, add_backtrace=True, evalue_thr=0.001)
    jres = jpipe.search(jq, jt, jparams.SearchParams(**kw), same_db=False)
    tres = tpipe.search(tq, tt, SearchParams(**kw), torch.device("cpu"),
                        same_db=False)
    return (jprofile.result2profile(jq, jt, jres),
            tprofile.result2profile(tq, tt, tres))


@pytest.mark.parametrize("k", [6, 7])
def test_kmer_pssm_queries_match_jax(dbs, profiles, k):
    """`query_pssm` with the stored 3Di PSSM bytes of iterative search:
    equal (target, score, diagonal) lists."""
    (jt, jq), (tt, tq) = dbs["synth150"]
    jprofs, tprofs = profiles
    jpref = jkmer.KmerPrefilter(jt, jparams.SearchParams(), k=k,
                                bias_scale=0.15, profile_mode=True)
    tpref = tkmer.KmerPrefilter(tt, SearchParams(), k=k, bias_scale=0.15,
                                profile_mode=True)
    n = 0
    for qi in range(tq.size):
        key = int(tq.keys[qi])
        jp = jprofile.pssm_store_bytes(jprofs[key].prob_ss, jmat3di().p_back,
                                       comp_bias_correction=False)
        tp = tprofile.pssm_store_bytes(tprofs[key].prob_ss, mat3di().p_back,
                                       comp_bias_correction=False)
        assert np.array_equal(jp, tp)
        letters = np.asarray(tq.get_ss(qi), dtype=np.int64)
        want = jpref.query_pssm(jp, letters, 300)
        got = tpref.query_pssm(tp, letters, 300)
        assert got == want
        n += len(want)
    assert n > 20


def test_kmer_prefilter_reads_a_createindex_artifact(dbs, tmp_path):
    """An index written by foldseek_tpu's `create_index` is read by the
    port's `load_index`; the prefilter built from it holds the same posting
    lists as one built from the sequences and gives the same candidates."""
    (jt, jq), (tt, tq) = dbs["synth150"]
    shutil.copytree(jt.path, tmp_path / "idx_db")
    jdb = jstorage.load_db(str(tmp_path / "idx_db"))
    jindex.create_index(jdb)
    tdb = tdbmod.load_db(str(tmp_path / "idx_db"))
    idx = tindex.load_index(tdb)
    assert idx is not None and idx["manifest"]["n_entries"] == tdb.size
    assert tindex.load_index(tt) is None
    from_index = tkmer.KmerPrefilter(tdb, SearchParams(), k=0, bias_scale=0.15)
    from_seqs = tkmer.KmerPrefilter(tt, SearchParams(), k=0, bias_scale=0.15)
    for name in ("post_ids", "post_off", "post_tid", "post_pos"):
        assert np.array_equal(getattr(from_index, name),
                              getattr(from_seqs, name)), name
    assert tkmer.kmer_prefilter(tq, tdb, SearchParams()) == \
        jkmer.kmer_prefilter(jq, jdb, jparams.SearchParams())


def test_fork_rule(monkeypatch):
    """The fork-parallel path is taken unless the process holds a CUDA
    context; FOLDSEEK_TPU_FORK overrides both ways."""
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "1")
    assert tkmer._fork_unsafe() is False
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    assert tkmer._fork_unsafe() is True
    monkeypatch.delenv("FOLDSEEK_TPU_FORK")
    import torch
    assert tkmer._fork_unsafe() == torch.cuda.is_initialized()

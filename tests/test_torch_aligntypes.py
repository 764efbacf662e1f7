"""Alignment types 1 (TM-align) and 3 (LoLalign) and samplemulambda of the
port against foldseek_tpu on the fixture synth DB. The stages compute on the
host in both packages (numpy and the native library, copied with the imports
rewritten), so records and m8 bytes are compared exactly; samplemulambda's SW
scores are integers and its fit is the same numpy code, so it is exact too."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from foldseek_tpu.search import convertalis as jconv
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipe
from foldseek_tpu.search import samplemulambda as jsml
from foldseek_tpu_torch.search import SearchParams, format_results
from foldseek_tpu_torch.search import pipeline as tpipe
from foldseek_tpu_torch.search import samplemulambda as tsml

from _torch_adapters import few_torch_threads, make_fixture_dbs

_few_threads = pytest.fixture(autouse=True, scope="module")(
    few_torch_threads)

CPU = torch.device("cpu")
COLUMNS = (SearchParams().format_output
           + ",alntmscore,qtmscore,ttmscore,lddt,prob,cigar")


@pytest.fixture(autouse=True)
def _sequential_prefilter(monkeypatch):
    """This process holds a live JAX client beside the port: keep the
    port's k-mer prefilter from forking it."""
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    return make_fixture_dbs(golden_dir, tmp_path_factory.mktemp("torch_at"),
                            60, 3)


def _same(a, b) -> bool:
    """Exact equality of two record fields (NaN equal to NaN)."""
    if isinstance(a, (np.ndarray, float)) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a, dtype=np.float64),
                              np.asarray(b, dtype=np.float64), equal_nan=True)
    return a == b


@pytest.mark.parametrize("prefilter_mode", [0, 1])
@pytest.mark.parametrize("alignment_type", [1, 3])
def test_alignment_type_records_and_m8_match_jax(dbs, alignment_type,
                                                 prefilter_mode):
    (jt, jq), (tt, tq) = dbs
    kw = dict(prefilter_mode=prefilter_mode, alignment_type=alignment_type,
              add_backtrace=True)
    want = jpipe.search(jq, jt, jparams.SearchParams(**kw), same_db=False)
    got = tpipe.search(tq, tt, SearchParams(**kw), CPU, same_db=False)
    assert list(got) == list(want)
    n = 0
    for key in want:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            gd, wd = asdict(g), asdict(w)
            assert set(gd) == set(wd)
            for name in wd:
                assert _same(gd[name], wd[name]), name
            n += 1
    assert n > 100
    w = jconv.format_results(jq, jt, want, COLUMNS, with_backtrace=True)
    g = format_results(tq, tt, got, COLUMNS, with_backtrace=True)
    assert g == w


def test_alignment_types_differ_from_the_default(dbs):
    """Types 1 and 3 really take other stages than structurealign."""
    _, (tt, tq) = dbs
    out = {}
    for at in (1, 2, 3):
        res = tpipe.search(tq, tt, SearchParams(
            prefilter_mode=1, alignment_type=at, add_backtrace=True,
            max_seqs=20), CPU, same_db=False)
        out[at] = format_results(tq, tt, res, COLUMNS, with_backtrace=True)
    assert out[1] != out[2] and out[3] != out[2] and out[1] != out[3]


@pytest.mark.parametrize("seed,n_samples", [(42, 24), (7, 10)])
def test_sample_mu_lambda_matches_jax(dbs, seed, n_samples):
    (jt, jq), (tt, tq) = dbs
    want = jsml.sample_mu_lambda(jq, jt, n_samples=n_samples, seed=seed)
    got = tsml.sample_mu_lambda(tq, tt, CPU, n_samples=n_samples, seed=seed)
    assert got == want and len(got) == tq.size
    assert all(lam > 0 for _, lam in got.values())
    assert np.allclose(tsml.evd_max_likelihood_fit(np.arange(5, 30.0)),
                       jsml.evd_max_likelihood_fit(np.arange(5, 30.0)),
                       rtol=0, atol=0)

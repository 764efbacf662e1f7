"""The port's multimer (complex) workflows on the CPU against foldseek_tpu:
expandmultimer, the scorecomplex lines of `multimer_search`, the
easy-multimersearch report and the easy-multimercluster files, all exact
(both sides score TM and LDDT on the host in numpy).

Complexes of two kinds go to both packages: multi-chain PDB files written
here (two fixture structures as chains A and B of one file) through each
package's own `create_db`, and a synthetic DB whose `fileids` group entries
two by two. The port's k-mer prefilter must not fork this process (it holds
a live JAX client), hence FOLDSEEK_TPU_FORK=0."""
import numpy as np
import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.multimer import expand as jexpand
from foldseek_tpu.multimer import report as jreport
from foldseek_tpu.multimer import scoremultimer as jscore
from foldseek_tpu.multimer import workflow as jwf
from foldseek_tpu.search import params as jparams
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.multimer import expand as texpand
from foldseek_tpu_torch.multimer import report as treport
from foldseek_tpu_torch.multimer import scoremultimer as tscore
from foldseek_tpu_torch.multimer import workflow as twf
from foldseek_tpu_torch.search import SearchParams

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's plain PyTorch work: the suite
    runs several files at once on a few cores, and the other torch and JAX
    pools are already busy."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chain_lines(path, chain: str, shift: float):
    """The ATOM records of a one-chain C-alpha PDB file relabelled as
    `chain`, moved by `shift` angstrom along x."""
    out = []
    for line in open(path):
        if line.startswith("ATOM"):
            x = float(line[30:38]) + shift
            out.append(f"{line[:21]}{chain}{line[22:30]}{x:8.3f}{line[38:]}")
    return out


@pytest.fixture(scope="module")
def complex_dir(golden_dir, tmp_path_factory):
    """Eight two-chain PDB files from the fixture structures: chain A and,
    about 9 angstrom beside it, chain B. Complexes 6 and 7 repeat 0 and 2
    (6 with chain B moved by 0.3 angstrom): the clustering finds members."""
    d = tmp_path_factory.mktemp("torch_complexes")
    files = sorted((golden_dir / "msa" / "sup").glob("*.pdb"))
    for c, (src, shift) in enumerate([(0, 9.0), (1, 9.0), (2, 9.0), (3, 9.0),
                                      (4, 9.0), (5, 9.0), (0, 9.3), (2, 9.0)]):
        a, b = files[(2 * src) % len(files)], files[(5 * src + 3) % len(files)]
        lines = _chain_lines(a, "A", 0.0) + _chain_lines(b, "B", shift)
        (d / f"cplx{c}.pdb").write_text("".join(lines) + "END\n")
    return d


@pytest.fixture(scope="module")
def complexes(complex_dir, golden_dir, tmp_path_factory):
    """kind -> (jax qdb, jax tdb, port qdb, port tdb). "pdb": the eight
    complex files through each package's create_db (both DBs the same);
    "synth": 80 synthetic entries and 8 queries with fileids i // 2."""
    d = tmp_path_factory.mktemp("torch_multimer_dbs")
    out = {}
    jdb = create_db([str(complex_dir)], str(d / "pdb_jax"))
    tdb = tdbmod.create_db([str(complex_dir)], str(d / "pdb_port"))
    out["pdb"] = (jdb, jdb, tdb, tdb)
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    base = create_db(inputs, str(d / "base"))
    for name, n, seed in (("t80", 80, 1), ("q8", 8, 4)):
        synth_db(base, n, str(d / name), seed=seed)
        np.save(str(d / name / "fileids.npy"),
                (np.arange(n) // 2).astype(np.uint32))
    out["synth"] = (jstorage.load_db(str(d / "q8")),
                    jstorage.load_db(str(d / "t80")),
                    tdbmod.load_db(str(d / "q8")), tdbmod.load_db(str(d / "t80")))
    return out


def test_complex_dbs_are_identical(complexes, complex_dir):
    """Both packages' create_db write the same complex DB: two chains per
    file, grouped by fileids."""
    jdb, _, tdb, _ = complexes["pdb"]
    assert tdb.names == jdb.names and len(tdb.names) == 16
    assert np.array_equal(tdb.fileids, jdb.fileids)
    _, chains, order = tscore.complex_maps(tdb)
    assert len(order) == 8 and all(len(chains[c]) == 2 for c in order)
    assert tscore.complex_maps(tdb) == jscore.complex_maps(jdb)


@pytest.mark.parametrize("kind", ["pdb", "synth"])
def test_expand_multimer_matches_jax(complexes, kind):
    jq, jt, tq, tt = complexes[kind]
    rng = np.random.default_rng(3)
    tkeys = [int(k) for k in tt.keys]
    hits = {int(k): [int(t) for t in rng.choice(tkeys, 3, replace=False)]
            for k in tq.keys[::3]}
    got = texpand.expand_multimer(tq, tt, hits)
    assert got == jexpand.expand_multimer(jq, jt, hits)
    assert sum(len(v) for v in got.values()) > 2 * len(hits)


@pytest.mark.parametrize("kind,kw", [("pdb", {}),
                                     ("synth", dict(prefilter_mode=1))])
def test_multimer_search_matches_jax(complexes, kind, kw):
    """scorecomplex lines (alignment, qTM, tTM, u, t, assignment id), the
    default k-mer prefilter on the PDB complexes and --gpu 1's gapless one on
    the synthetic complexes; then the report built from them."""
    jq, jt, tq, tt = complexes[kind]
    want = jwf.multimer_search(jq, jt, jparams.SearchParams(**kw))
    got = twf.multimer_search(tq, tt, SearchParams(**kw), CPU)
    assert got == want
    assert sum(len(v) for v in got.values()) >= tq.size
    report = treport.create_multimer_report(tq, tt, got)
    assert report == jreport.create_multimer_report(jq, jt, want)
    assert len(report) >= 2


def test_easy_multimersearch_matches_jax(complex_dir, tmp_path):
    """easy-multimersearch of the complex files against themselves: the
    report file byte for byte; multimersearch on the DB writes the same
    complexres DB."""
    args = [str(complex_dir), str(complex_dir)]
    assert jmain(["easy-multimersearch", *args, str(tmp_path / "jax"),
                  str(tmp_path / "tmp_jax"), "-v", "1"]) == 0
    assert tmain(["easy-complexsearch", *args, str(tmp_path / "port"),
                  str(tmp_path / "tmp_port"), "--device", "cpu",
                  "-v", "1"]) == 0
    want = (tmp_path / "jax_report").read_bytes()
    assert want and (tmp_path / "port_report").read_bytes() == want
    db = str(tmp_path / "tmp_jax" / "query_db")
    assert jmain(["multimersearch", db, db, str(tmp_path / "jax_res"),
                  str(tmp_path / "tmp_jax2"), "-v", "1"]) == 0
    assert tmain(["multimersearch", db, db, str(tmp_path / "port_res"),
                  str(tmp_path / "tmp_port2"), "--device", "cpu",
                  "-v", "1"]) == 0
    want = (tmp_path / "jax_res").read_text()
    assert want.startswith("#foldseek-tpu complexres v1\n")
    assert (tmp_path / "port_res").read_text() == want


def test_easy_multimercluster_matches_jax(complex_dir, tmp_path):
    """easy-multimercluster with the card's default gates (multimer TM 0.7,
    chain TM 0.7, interface LDDT 0.3): `_cluster.tsv` and `_rep_seq.fasta`
    byte for byte; multimercluster on the DB writes the same tsv."""
    assert jmain(["easy-multimercluster", str(complex_dir),
                  str(tmp_path / "jax"), str(tmp_path / "tmp_jax"),
                  "-v", "1"]) == 0
    assert tmain(["easy-multimercluster", str(complex_dir),
                  str(tmp_path / "port"), str(tmp_path / "tmp_port"),
                  "--device", "cpu", "-v", "1"]) == 0
    for suffix in ("_cluster.tsv", "_rep_seq.fasta"):
        want = (tmp_path / f"jax{suffix}").read_bytes()
        assert want and (tmp_path / f"port{suffix}").read_bytes() == want
    rows = [ln.split("\t") for ln in
            (tmp_path / "port_cluster.tsv").read_text().splitlines()]
    assert len(rows) == 8 and sum(r != m for r, m in rows) >= 1
    db = str(tmp_path / "tmp_jax" / "query_db")
    assert jmain(["multimercluster", db, str(tmp_path / "jax.tsv"),
                  str(tmp_path / "tmp_jax2"), "-v", "1"]) == 0
    assert tmain(["multimercluster", db, str(tmp_path / "port.tsv"),
                  str(tmp_path / "tmp_port2"), "--device", "cpu",
                  "-v", "1"]) == 0
    assert (tmp_path / "port.tsv").read_bytes() == \
        (tmp_path / "jax_cluster.tsv").read_bytes()


def test_multimer_search_resumes(complexes, tmp_path, monkeypatch):
    """With a tmp dir the expand re-align persists; a second run reads it
    back without aligning anything and returns the same lines."""
    _, _, tq, tt = complexes["synth"]
    params = SearchParams(prefilter_mode=1)
    first = twf.multimer_search(tq, tt, params, CPU, tmp_dir=str(tmp_path))
    monkeypatch.setattr(twf, "align_all",
                        lambda *a, **k: pytest.fail("the re-align ran"))
    again = twf.multimer_search(tq, tt, params, CPU, tmp_dir=str(tmp_path))
    assert again == first


# --- the JAX package's golden tests, for the port -----------------------------

def test_port_easy_multimersearch_tim_golden(example_dir, golden_dir,
                                             tmp_path):
    report = twf.easy_multimer_search(
        str(example_dir / "1tim.pdb.gz"), str(example_dir / "8tim.pdb.gz"),
        str(tmp_path / "tim"), str(tmp_path / "tmp"), SearchParams(), CPU)
    golden = [ln.rstrip("\n") for ln in open(golden_dir / "timcomplex_report")]
    assert len(report) == len(golden)
    for mine, ref in zip(report, golden):
        fm, fr = mine.split("\t"), ref.split("\t")
        assert fm[:4] == fr[:4] and fm[13] == fr[13]
        # TM scores to 1e-4 (float32 Kabsch round-off)
        assert abs(float(fm[4]) - float(fr[4])) < 1e-4, (mine, ref)
        assert abs(float(fm[5]) - float(fr[5])) < 1e-4, (mine, ref)
        for um, ur in zip(fm[6].split(","), fr[6].split(",")):
            assert abs(float(um) - float(ur)) < 1e-3


def test_port_easy_multimercluster_golden(example_dir, golden_dir, tmp_path):
    import shutil
    inp = tmp_path / "in"
    inp.mkdir()
    for name in ("1tim.pdb.gz", "8tim.pdb.gz", "d1asha_", "d1mbaa_"):
        shutil.copy(example_dir / name, inp / name)
    assert tmain(["easy-multimercluster", str(inp), str(tmp_path / "clu"),
                  str(tmp_path / "tmp"), "--device", "cpu", "-v", "1"]) == 0
    assert (tmp_path / "clu_cluster.tsv").read_text() == \
        (golden_dir / "mmclu_cluster.tsv").read_text()
    fasta = (tmp_path / "clu_rep_seq.fasta").read_text()
    assert "#8tim" in fasta and "#d1asha_" in fasta and "#1tim" not in fasta

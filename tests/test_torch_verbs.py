"""The port's DB, stage and output verbs on the CPU against foldseek_tpu's:
createdb, createindex, compressca, samplemulambda, result2profile, prefilter,
ungappedprefilter, structurealign, tmalign, lolalign, aln2tmscore and
convertalis write the same bytes as `python -m foldseek_tpu` on the same
inputs. Also the indexed-view repair: an index is read only by the DB it
describes, so clusters of an indexed DB equal those without the index, and a
key-subset view of an indexed DB is searched as the same subset written as a
DB of its own.

The two packages meet only through files: each side's `cli.main` reads the
same input directories and writes its own outputs, which are compared byte
for byte. The port's k-mer prefilter must not fork this process (it holds a
live JAX client), hence FOLDSEEK_TPU_FORK=0."""
import os
import shutil

import numpy as np
import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.cluster import workflow as twf
from foldseek_tpu_torch.db import index as tindex
from foldseek_tpu_torch.db.panels import TorchPanelSet
from foldseek_tpu_torch.search import SearchParams
from foldseek_tpu_torch.search import kmer as tkmer
from foldseek_tpu_torch.search import ungapped as tung

CPU = torch.device("cpu")
QUIET = ["-v", "1"]
ON_CPU = ["--device", "cpu"]
# every column of format_row but the taxonomy and complex ones
ALL_COLUMNS = ("query,target,fident,pident,nident,alnlen,mismatch,gapopen,"
               "qstart,qend,tstart,tend,qlen,tlen,evalue,bits,raw,qcov,tcov,"
               "cigar,qseq,tseq,q3di,t3di,qheader,theader,qaln,taln,q3dialn,"
               "t3dialn,qset,qsetid,tset,tsetid,qtmscore,ttmscore,alntmscore,"
               "rmsd,lddt,lddtfull,u,t,qca,tca,prob,empty")
COMPLEX_COLUMNS = ("query,target,qtmscore,complexqtmscore,complexttmscore,"
                   "complexu,complext,complexassignid,qcomplexcoverage,"
                   "tcomplexcoverage,qchaintms,tchaintms,interfacelddt,"
                   "qchains,tchains")


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's plain PyTorch work: the suite
    runs several files at once on a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fixture_inputs(golden_dir):
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_tree(a, b):
    """Every file below `a` equals the file of the same name below `b`."""
    names_a = sorted(os.path.relpath(os.path.join(r, n), a)
                     for r, _, ns in os.walk(a) for n in ns)
    names_b = sorted(os.path.relpath(os.path.join(r, n), b)
                     for r, _, ns in os.walk(b) for n in ns)
    assert names_a == names_b
    for n in names_a:
        assert _read(os.path.join(a, n)) == _read(os.path.join(b, n)), n
    return names_a


def _both(verb, args, port_extra=()):
    """Run `verb` through each package's CLI on the same inputs; `args` holds
    "{out}" where each side writes its own output."""
    outs = []
    for side, main, extra in (("jax", jmain, ()), ("port", tmain, port_extra)):
        out = args["out"] + "_" + side
        argv = [verb] + [a.format(out=out) for a in args["argv"]] + QUIET
        assert main(argv + list(extra)) == 0, (side, argv)
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def work(golden_dir, tmp_path_factory):
    """A 60-entry target DB and 3 queries grown from the 17 fixture
    structures by db/synth.py; JAX-written exhaustive result DBs of the
    queries against the targets, with and without backtraces."""
    d = tmp_path_factory.mktemp("torch_verbs")
    base = create_db(_fixture_inputs(golden_dir), str(d / "base"))
    synth_db(base, 60, str(d / "t60"), seed=1)
    synth_db(base, 3, str(d / "q3"), seed=4)
    paths = {k: str(d / k) for k in ("base", "t60", "q3")}
    for name, extra in (("aln_bt", ["-a"]), ("aln", [])):
        paths[name] = str(d / name)
        assert jmain(["search", paths["q3"], paths["t60"], paths[name],
                      str(d / f"tmp_{name}"), "--exhaustive-search", "1"]
                     + extra + QUIET) == 0
    paths["dir"] = str(d)
    return paths


@pytest.mark.parametrize("case", ["default", "chain_name_mode", "write_lookup",
                                  "coord_store_mode", "tax_mapping",
                                  "file_include"])
def test_createdb_matches_jax(golden_dir, tmp_path, case):
    """Every file of the DB directory (and the .lookup beside it) equals the
    one foldseek_tpu's createdb writes."""
    inputs = _fixture_inputs(golden_dir)
    extra = {"default": [], "chain_name_mode": ["--chain-name-mode", "1"],
             "write_lookup": ["--write-lookup", "1"],
             "coord_store_mode": ["--coord-store-mode", "2"]}.get(case, [])
    if case == "tax_mapping":
        tsv = tmp_path / "taxa.tsv"
        tsv.write_text("".join(f"{os.path.basename(p).split('.')[0]}\t{9606 + i}\n"
                               for i, p in enumerate(inputs)))
        extra = ["--tax-mapping-file", str(tsv)]
    if case == "file_include":
        inputs = [str(golden_dir / "msa" / "sup")]
        extra = ["--file-include", "d1asha", "--file-exclude", "d1itha"]
    outs = []
    for side, main in (("jax", jmain), ("port", tmain)):
        out = str(tmp_path / side)
        assert main(["createdb", *inputs, out, *extra, *QUIET]) == 0
        outs.append(out)
    names = _same_tree(*outs)
    want = {"coord_store_mode": "ca16.bin", "tax_mapping": "mapping.tsv"}
    assert want.get(case, "keys.npy") in names
    if case == "write_lookup":
        assert _read(outs[0] + ".lookup") == _read(outs[1] + ".lookup")
        assert len(_read(outs[1] + ".lookup").splitlines()) == 17
    if case == "file_include":
        assert len(tdbmod.load_db(outs[1]).keys) == 5
    if case == "tax_mapping":
        assert "9606" in (tmp_path / "port" / "mapping.tsv").read_text()


@pytest.fixture(scope="module")
def indexed(work):
    """Copies of the target DB, each indexed by one package's createindex."""
    outs = []
    for side, main in (("jax", jmain), ("port", tmain)):
        path = os.path.join(work["dir"], f"t60_indexed_{side}")
        shutil.copytree(work["t60"], path)
        assert main(["createindex", path, *QUIET]) == 0
        outs.append(path)
    return outs


def test_createindex_matches_jax(work, indexed):
    """The index files equal foldseek_tpu's byte for byte, and the port reads
    its bucket panels from them."""
    names = _same_tree(*(os.path.join(p, "index") for p in indexed))
    assert "manifest.json" in names and "kmer_ids.npy" in names
    db = tdbmod.load_db(indexed[1])
    from_index = TorchPanelSet(db, CPU).buckets
    assert all(isinstance(b.panel_T, np.memmap) for b in from_index)
    built = TorchPanelSet(tdbmod.load_db(work["t60"]), CPU).buckets
    for a, b in zip(from_index, built):
        assert np.array_equal(a.panel_T, b.panel_T)
        assert np.array_equal(a.entry_idx, b.entry_idx)


@pytest.mark.parametrize("mode", [["--gpu", "1"], []])
def test_search_same_with_and_without_index(work, indexed, tmp_path, mode):
    """`search` of an indexed DB (the panels in mode 1, the k-mer postings in
    mode 0 come from the index) writes the same result DB as of the DB
    without one."""
    outs = []
    for tdb in (work["t60"], indexed[1]):
        out = str(tmp_path / os.path.basename(tdb))
        assert tmain(["search", work["q3"], tdb, out, str(tmp_path / "tmp"),
                      *mode, *ON_CPU, *QUIET]) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 20


def test_compressca_matches_jax(work, tmp_path):
    outs = _both("compressca", dict(out=str(tmp_path / "ca16"),
                                    argv=[work["t60"], "{out}"]))
    for suffix in ("", ".offsets.npy"):
        assert _read(outs[0] + suffix) == _read(outs[1] + suffix)


def test_samplemulambda_matches_jax(work, tmp_path):
    """mu and lambda of each query from the SW scores against shuffled
    targets (the SW kernel's plain version here)."""
    outs = _both("samplemulambda", dict(out=str(tmp_path / "ml"),
                                        argv=[work["q3"], work["t60"], "{out}",
                                              "--n-samples", "40"]), ON_CPU)
    assert _read(outs[0]) == _read(outs[1])
    assert len(_read(outs[1]).splitlines()) == 3


def test_result2profile_matches_jax(work, tmp_path):
    outs = _both("result2profile", dict(out=str(tmp_path / "prof"),
                                        argv=[work["q3"], work["t60"],
                                              work["aln_bt"], "{out}"]))
    assert _same_tree(*outs)


@pytest.mark.parametrize("verb", ["prefilter", "ungappedprefilter"])
def test_prefilter_verbs_match_jax(work, tmp_path, verb):
    outs = _both(verb, dict(out=str(tmp_path / verb),
                            argv=[work["q3"], work["t60"], "{out}"]),
                 ON_CPU if verb == "ungappedprefilter" else ())
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 10


@pytest.mark.parametrize("verb", ["structurealign", "tmalign", "lolalign"])
def test_module_aligners_match_jax(work, tmp_path, verb):
    """Each aligner re-aligns the exhaustive result DB's pairs."""
    outs = _both(verb, dict(out=str(tmp_path / verb),
                            argv=[work["q3"], work["t60"], work["aln"],
                                  "{out}", "-a"]), ON_CPU)
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 20


def test_aln2tmscore_matches_jax(work, tmp_path):
    outs = _both("aln2tmscore", dict(out=str(tmp_path / "tm"),
                                     argv=[work["q3"], work["t60"],
                                           work["aln_bt"], "{out}"]))
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 20


CONVERTALIS_CASES = {
    **{f"mode{m}": ("aln_bt", ["--format-mode", str(m)]) for m in range(6)},
    "mode0_no_backtrace": ("aln", []),
    "mode4_no_backtrace": ("aln", ["--format-mode", "4"]),
    "all_columns": ("aln_bt", ["--format-output", ALL_COLUMNS]),
    "all_columns_no_backtrace": ("aln", ["--format-output", ALL_COLUMNS]),
}


@pytest.mark.parametrize("case", sorted(CONVERTALIS_CASES))
def test_convertalis_matches_jax(work, tmp_path, case):
    """Format modes 0-5 and every column, with and without stored
    backtraces."""
    result, extra = CONVERTALIS_CASES[case]
    if case == "mode5":
        # one superposed PDB file a hit, named <output><query>_<target>.pdb
        for side in ("jax", "port"):
            (tmp_path / f"out_{side}").mkdir()
        outs = _both("convertalis", dict(out=str(tmp_path / "out"),
                                         argv=[work["q3"], work["t60"],
                                               work[result], "{out}/",
                                               *extra]))
        assert len(_same_tree(*outs)) > 20
        return
    outs = _both("convertalis", dict(out=str(tmp_path / "out"),
                                     argv=[work["q3"], work["t60"],
                                           work[result], "{out}", *extra]))
    assert _read(outs[0]) == _read(outs[1])
    assert len(_read(outs[1])) > 1000


def test_convertalis_profile_query_matches_jax(work, tmp_path):
    """A profile DB (result2profile) on the query side: the port's profile
    search, printed by each package."""
    prof = str(tmp_path / "prof")
    assert tmain(["result2profile", work["q3"], work["t60"], work["aln_bt"],
                  prof, *QUIET]) == 0
    res = str(tmp_path / "res")
    assert tmain(["search", prof, work["t60"], res, str(tmp_path / "tmp"),
                  "-a", *ON_CPU, *QUIET]) == 0
    outs = _both("convertalis", dict(out=str(tmp_path / "out"),
                                     argv=[prof, work["t60"], res, "{out}"]))
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") >= 3


def test_convertalis_clustered_target_matches_jax(work, tmp_path):
    """A cluster-search result names members of the `<target>_seq` DB, which
    convertalis reads in place of the representatives."""
    keys = [int(k) for k in tdbmod.load_db(work["t60"]).keys]
    tsv = tmp_path / "clu.tsv"
    tsv.write_text("".join(f"{keys[i - i % 5]}\t{k}\n"
                           for i, k in enumerate(keys)))
    cdb = str(tmp_path / "cdb")
    assert tmain(["createclusearchdb", work["t60"], str(tsv), cdb,
                  *QUIET]) == 0
    res = str(tmp_path / "res")
    assert tmain(["search", work["q3"], cdb, res, str(tmp_path / "tmp"),
                  "--cluster-search", "1", "--gpu", "1", *ON_CPU,
                  *QUIET]) == 0
    outs = _both("convertalis", dict(out=str(tmp_path / "out"),
                                     argv=[work["q3"], cdb, res, "{out}"]))
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 20


def test_convertalis_complexres_matches_jax(work, tmp_path):
    """A multimersearch result (`#foldseek-tpu complexres`) with the complex
    columns and a header line."""
    cdb = str(tmp_path / "complexes")
    synth_db(tdbmod.load_db(work["base"]), 12, cdb, seed=3)
    np.save(os.path.join(cdb, "fileids.npy"),
            (np.arange(12) // 2).astype(np.uint32))
    res = str(tmp_path / "res")
    assert tmain(["multimersearch", cdb, cdb, res, str(tmp_path / "tmp"),
                  "--gpu", "1", *ON_CPU, *QUIET]) == 0
    assert _read(res).startswith(b"#foldseek-tpu complexres")
    outs = _both("convertalis", dict(out=str(tmp_path / "out"),
                                     argv=[cdb, cdb, res, "{out}",
                                           "--format-output", COMPLEX_COLUMNS,
                                           "--format-mode", "4"]))
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 6


def test_indexed_db_clusters_as_without_index(work, tmp_path):
    """`createindex db -s 8`, then `cluster db` with the defaults: the last
    cascade step runs at -s 8 over a key-subset view of the DB, whose
    k-mer postings and panels must not come from the parent's index. The
    clusters equal those of the same DB without `index/` (foldseek_tpu
    keeps the fault, so the port is held against itself)."""
    plain, idx = str(tmp_path / "plain"), str(tmp_path / "idx")
    shutil.copytree(work["t60"], plain)
    shutil.copytree(work["t60"], idx)
    assert tmain(["createindex", idx, "-s", "8", *QUIET]) == 0
    outs = []
    for db in (plain, idx):
        out = db + ".json"
        assert tmain(["cluster", db, out, db + "_tmp", *ON_CPU, *QUIET]) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1]
    assert outs[0].count(b":") >= 2


def test_view_of_indexed_db_reads_no_parent_index(work, indexed, tmp_path):
    """A `_subdb_view` of an indexed DB keeps the parent's path: its index
    is refused (`describes`), and the ungapped and k-mer prefilters over the
    view equal those over the same subset written as a DB of its own
    (foldseek_tpu's createsubdb)."""
    parent = tdbmod.load_db(indexed[1])
    keys = [int(k) for k in parent.keys][::3]
    ids = tmp_path / "ids.txt"
    ids.write_text("".join(f"{k}\n" for k in keys))
    sub_path = str(tmp_path / "sub")
    assert jmain(["createsubdb", str(ids), indexed[1], sub_path, *QUIET]) == 0
    view, sub = twf._subdb_view(parent, keys), tdbmod.load_db(sub_path)
    assert view.path == parent.path and tindex.load_index(view) is None
    assert tindex.load_index(parent) is not None
    qdb = tdbmod.load_db(work["q3"])
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    params = SearchParams()
    got, want = (tung.UngappedPrefilter(db, CPU).query_batch(seqs, params)
                 for db in (view, sub))
    assert got == want and sum(map(len, want)) > 10
    got, want = (tkmer.kmer_prefilter(qdb, db, params) for db in (view, sub))
    assert got == want and sum(map(len, want.values())) > 3

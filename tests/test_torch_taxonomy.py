"""The port's taxonomy verbs on the CPU against foldseek_tpu's: createtaxdb,
addtaxonomy, filtertaxseqdb, lca, majoritylca, filtertaxdb, taxonomyreport
and easy-taxonomy write the same bytes as `python -m foldseek_tpu` on the same
inputs (a toy NCBI taxdump, the repo's fixture structures with a taxid
mapping).

The two packages meet only through files: each side's `cli.main` reads the
same inputs and writes its own outputs, which are compared byte for byte.
The port's k-mer prefilter must not fork this process (it holds a live JAX
client), hence FOLDSEEK_TPU_FORK=0."""
import os
import shutil

import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu_torch.cli import main as tmain

QUIET = ["-v", "1"]
ON_CPU = ["--device", "cpu"]

# toy tree:  1 (root) -> 1000 (superkingdom) -> 2000 (phylum)
#            2000 -> 2100 (genus) -> 2110, 2120 (species)
#            2000 -> 2200 (genus) -> 2210 (species)
NODES = """1\t|\t1\t|\tno rank\t|
1000\t|\t1\t|\tsuperkingdom\t|
2000\t|\t1000\t|\tphylum\t|
2100\t|\t2000\t|\tgenus\t|
2110\t|\t2100\t|\tspecies\t|
2120\t|\t2100\t|\tspecies\t|
2200\t|\t2000\t|\tgenus\t|
2210\t|\t2200\t|\tspecies\t|
"""
NAMES = """1\t|\troot\t|\t\t|\tscientific name\t|
1000\t|\tBacteria\t|\t\t|\tscientific name\t|
2000\t|\tProteos\t|\t\t|\tscientific name\t|
2100\t|\tEscher\t|\t\t|\tscientific name\t|
2110\t|\tE. coli\t|\t\t|\tscientific name\t|
2120\t|\tE. albertii\t|\t\t|\tscientific name\t|
2200\t|\tSalmo\t|\t\t|\tscientific name\t|
2210\t|\tS. enterica\t|\t\t|\tscientific name\t|
"""
# the taxa the fixture entries are mapped to, in turn; 0 leaves an entry
# unmapped
TAXA = (2110, 2120, 2210, 2110, 0, 2210, 2120)


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


def _both(verb, out, argv, port_extra=()):
    """Run `verb` through each package's CLI; `argv` holds "{out}" where each
    side writes its own output. Returns the two output paths."""
    outs = []
    for side, main, extra in (("jax", jmain, ()), ("port", tmain, port_extra)):
        path = f"{out}_{side}"
        args = [verb] + [a.format(out=path) for a in argv] + QUIET
        assert main(args + list(extra)) == 0, (side, args)
        outs.append(path)
    return outs


@pytest.fixture(scope="module")
def taxo(golden_dir, tmp_path_factory):
    """The toy taxdump, the 17 fixture structures as a target DB with a
    name -> taxid mapping file, a copy of that DB with createtaxdb run by
    each package, and a JAX-written exhaustive result DB of the DB against
    itself (with backtraces)."""
    d = tmp_path_factory.mktemp("torch_taxonomy")
    dump = d / "taxdump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text(NODES)
    (dump / "names.dmp").write_text(NAMES)
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    db = create_db(inputs, str(d / "t17"))
    mapping = d / "mapping.tsv"
    mapping.write_text("".join(f"{name}\t{TAXA[i % len(TAXA)]}\n"
                               for i, name in enumerate(db.names)))
    paths = dict(dir=str(d), taxdump=str(dump), mapping=str(mapping),
                 plain=str(d / "t17"),
                 queries=str(golden_dir / "msa" / "sup"))
    for side, main in (("jax", jmain), ("port", tmain)):
        path = paths[f"taxdb_{side}"] = str(d / f"t17_{side}")
        shutil.copytree(paths["plain"], path)
        assert main(["createtaxdb", path, "--ncbi-tax-dump", str(dump),
                     "--tax-mapping-file", str(mapping), *QUIET]) == 0
    paths["res"] = str(d / "res")
    assert jmain(["search", paths["taxdb_jax"], paths["taxdb_jax"],
                  paths["res"], str(d / "tmp"), "--exhaustive-search", "1",
                  "-a", *QUIET]) == 0
    return paths


def test_createtaxdb_matches_jax(taxo):
    """mapping.tsv and the attached taxdump/ equal foldseek_tpu's."""
    names = _same_tree(taxo["taxdb_jax"], taxo["taxdb_port"])
    assert "mapping.tsv" in names and "taxdump/nodes.dmp" in names
    taxids = [line.split("\t")[1] for line in open(
        os.path.join(taxo["taxdb_port"], "mapping.tsv")).read().splitlines()]
    assert {"0", "2110", "2120", "2210"} == set(taxids)


LCA_CASES = {
    "default": ("lca", []),
    "uniform_votes": ("lca", ["--vote-mode", "0"]),
    "score_majority": ("lca", ["--vote-mode", "2", "--majority", "0.6"]),
    "ranks_lineage": ("lca", ["--lca-ranks", "genus,species",
                              "--tax-lineage", "1"]),
    "blacklist_taxids": ("lca", ["--blacklist", "2100", "--tax-lineage", "2"]),
    "majoritylca": ("majoritylca", []),
    "majoritylca_given": ("majoritylca", ["--majority", "0.9"]),
}


@pytest.mark.parametrize("case", sorted(LCA_CASES))
def test_lca_matches_jax(taxo, tmp_path, case):
    """lca and majoritylca over the exhaustive result DB, with the taxdump
    attached to the DB by createtaxdb."""
    verb, extra = LCA_CASES[case]
    outs = _both(verb, str(tmp_path / "lca"),
                 [taxo["taxdb_port"], taxo["res"], "{out}", *extra])
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") == 17


@pytest.mark.parametrize("expr", ["2100", "2000&&!2100", "2110,2210"])
def test_filtertaxdb_matches_jax(taxo, tmp_path, expr):
    outs = _both("filtertaxdb", str(tmp_path / "flt"),
                 [taxo["plain"], taxo["res"], "{out}", "--taxon-list", expr,
                  "--taxdump", taxo["taxdump"]])
    assert _read(outs[0]) == _read(outs[1])
    # filtertaxdb reads the mapping of the target DB: the plain DB has none,
    # so every record is filtered away; the attached one keeps some
    outs = _both("filtertaxdb", str(tmp_path / "flt_tax"),
                 [taxo["taxdb_port"], taxo["res"], "{out}", "--taxon-list",
                  expr])
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 10


@pytest.mark.parametrize("extra", [[], ["--tax-output-mode", "genus,species",
                                        "--tax-lineage", "1"],
                                   ["--tax-lineage", "2"]])
def test_addtaxonomy_matches_jax(taxo, tmp_path, extra):
    outs = _both("addtaxonomy", str(tmp_path / "add"),
                 [taxo["taxdb_port"], taxo["res"], "{out}", *extra])
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") > 100


def test_filtertaxseqdb_matches_jax(taxo, tmp_path):
    """The kept entries, their mapping and the linked taxdump."""
    outs = _both("filtertaxseqdb", str(tmp_path / "sub"),
                 [taxo["taxdb_port"], "{out}", "--taxon-list", "2100"])
    names = _same_tree(*outs)
    assert "taxdump/names.dmp" in names
    assert len(_read(os.path.join(outs[1], "mapping.tsv")).splitlines()) == 10


@pytest.mark.parametrize("source", ["result_db", "lca_tsv", "no_taxdump"])
def test_taxonomyreport_matches_jax(taxo, tmp_path, source):
    """The report over a result DB (LCA of each query's targets), over the
    lca verb's TSV, and without a taxdump (the taxids as they come)."""
    res, tdb = taxo["res"], taxo["taxdb_port"]
    if source == "lca_tsv":
        res = str(tmp_path / "lca.tsv")
        assert jmain(["lca", tdb, taxo["res"], res, *QUIET]) == 0
    if source == "no_taxdump":
        tdb = str(tmp_path / "no_dump")
        shutil.copytree(taxo["taxdb_port"], tdb)
        shutil.rmtree(os.path.join(tdb, "taxdump"))
    outs = _both("taxonomyreport", str(tmp_path / "report"),
                 [tdb, res, "{out}"])
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[1]).count(b"\n") >= 3


@pytest.mark.parametrize("mode", [["--gpu", "1"], [],
                                  ["--gpu", "1", "--lca-mode", "1",
                                   "--vote-mode", "2"]])
def test_easy_taxonomy_matches_jax(taxo, tmp_path, mode):
    """easy-taxonomy of the 16 fixture PDB files against the tax DB: its
    _lca.tsv, _report and _tophit_aln (mode 1 with --gpu 1, the k-mer
    prefilter without; the search on the CPU's plain versions)."""
    outs = []
    for side, main, extra in (("jax", jmain, []), ("port", tmain, ON_CPU)):
        prefix = str(tmp_path / side)
        assert main(["easy-taxonomy", taxo["queries"], taxo["taxdb_port"],
                     prefix, str(tmp_path / f"tmp_{side}"), *mode, *QUIET,
                     *extra]) == 0
        outs.append(prefix)
    for suffix in ("_lca.tsv", "_report", "_tophit_aln"):
        assert _read(outs[0] + suffix) == _read(outs[1] + suffix), suffix
    assert _read(outs[1] + "_lca.tsv").count(b"\n") == 16
    assert _read(outs[1] + "_tophit_aln").count(b"\n") == 16


def test_taxonomy_verbs_need_a_taxdump(taxo, tmp_path):
    """Without --taxdump, FOLDSEEK_TPU_TAXDUMP or an attached taxdump the
    verbs stop, as foldseek_tpu's do."""
    for main in (jmain, tmain):
        with pytest.raises(SystemExit):
            main(["lca", taxo["plain"], taxo["res"], str(tmp_path / "x"),
                  *QUIET])

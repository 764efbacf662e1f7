"""The port's 41 file-utility verbs on the CPU against foldseek_tpu's: each
verb (aliases included) runs the same argv through both packages' `cli.main`
on copies of the same inputs, and every file it writes, its stdout and its
exit code are compared byte for byte (`version`: the version number only).
Also the index cases: after `mvdb`, `lndb`, `appenddbtoindex` and
`renamedbkeys` of an indexed DB, the port takes the index exactly when
foldseek_tpu does, and `search --gpu 1` over the result prints the same m8.

The two packages meet only through files. The port's k-mer prefilter must
not fork this process (it holds a live JAX client), hence
FOLDSEEK_TPU_FORK=0."""
import os
import re
import shutil
import sys
import tarfile

import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.db import index as jindex
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.db import index as tindex

QUIET = ["-v", "1"]
# keeps every query's first record: the output stays alignment-shaped
APPLY_PROGRAM = [sys.executable, "-c",
                 "import sys; sys.stdout.write(''.join(sys.stdin.readlines()"
                 "[:1]))"]

# verb -> (argv with {in} for the shared inputs and {d} for the side's own
# directory, inputs copied into {d} first, whether the verb takes -v)
CASES = {
    "convert2pdb": (["{in}/q3", "{d}/out.pdb"], (), True),
    "structureto3didescriptor": (["{in}/sup", "{in}/d1asha.fcz",
                                  "{d}/out.tsv"], (), True),
    "convert2foldcomp": (["{in}/sup", "{in}/d1asha.fcz", "{d}/out_fcz"], (),
                         True),
    "convert2fasta": (["{in}/t60", "{d}/out.fasta", "--use-ss"], (), True),
    "createsubdb": (["{in}/ids", "{in}/t60", "{d}/sub"], (), True),
    "splitdb": (["{in}/t60", "{d}/split", "--split", "3", "--split-aa"], (),
                True),
    "concatdbs": (["{in}/t60", "{in}/q3", "{d}/cat"], (), True),
    "diffseqdbs": (["{in}/t60", "{in}/t40", "{d}/removed", "{d}/kept",
                    "{d}/new"], (), True),
    "mvdb": (["{d}/q3", "{d}/moved"], ("q3",), False),
    "rmdb": (["{d}/q3"], ("q3",), False),
    "lndb": (["{in}/t60", "{d}/linked"], (), False),
    "aliasdb": (["{in}/t60", "{d}/linked"], (), False),
    "renamedbkeys": (["{in}/keymap", "{in}/t60", "{d}/renamed"], (), True),
    "setextendeddbtype": (["{d}/q3", "--extended-dbtype", "2"], ("q3",),
                          True),
    "appenddbtoindex": (["{in}/q3", "{d}/t60_indexed", "--id-list", "500"],
                        ("t60_indexed",), True),
    "compress": (["{in}/aln_bt", "{d}/aln.zst"], (), False),
    "decompress": (["{in}/aln.zst", "{d}/aln"], (), False),
    "dbtype": (["{in}/aln_bt"], (), False),
    "view": (["{in}/t60", "--id-list", "3,7,{name5}"], (), False),
    "prefixid": (["{in}/aln_bt", "{d}/prefixed", "--mapping-file",
                  "{in}/qnames"], (), True),
    "tsv2db": (["{in}/aln.tsv", "{d}/from_tsv"], (), True),
    "tar2db": (["{in}/sup.tar", "{d}/from_tar"], (), True),
    "db2tar": (["{in}/q3", "{d}/q3.tar"], (), True),
    "unpackdb": (["{in}/aln_bt", "{d}/unpacked", "--unpack-suffix", ".m8"],
                 (), True),
    "sortresult": (["{in}/aln_bt", "{d}/sorted"], (), True),
    "subtractdbs": (["{in}/aln_bt", "{in}/aln_top", "{d}/rest"], (), True),
    "createtsv": (["{in}/q3", "{in}/t60", "{in}/aln_bt", "{d}/out.tsv"], (),
                  True),
    "mergedbs": (["{in}/aln_top", "{in}/aln", "{d}/merged"], (), True),
    "filterdb": (["{in}/aln_bt", "{d}/filtered", "--filter-expression",
                  "$2 > 100 * ($3 - 0.2)"], (), True),
    "result2flat": (["{in}/q3", "{in}/t60", "{in}/aln_bt", "{d}/flat"], (),
                    True),
    "result2repseq": (["{in}/t60", "{in}/aln_bt", "{d}/rep.fasta"], (),
                      True),
    "createseqfiledb": (["{in}/t60", "{in}/clu.tsv", "{d}/seqfile"], (),
                        True),
    "result2stats": (["{in}/aln_bt", "{d}/stats", "--stat", "mean",
                      "--stat-column", "2"], (), True),
    "summarizeheaders": (["{in}/q3", "{in}/t60", "{in}/aln_bt", "{d}/heads"],
                         (), True),
    "summarizeresult": (["{in}/aln_bt", "{d}/summary", "--overlap", "0.3"],
                        (), True),
    "extractalignedregion": (["{in}/q3", "{in}/t60", "{in}/aln_bt",
                              "{d}/regions", "--extract-mode", "1"], (),
                             True),
    "apply": (["{in}/aln_bt", "{d}/applied", "--", *APPLY_PROGRAM], (), True),
    "makepaddeddb": (["{d}/q3"], ("q3",), True),
    "makepaddedseqdb": (["{d}/q3", "-k", "6"], ("q3",), True),
    "mmcreateindex": (["{d}/q3", "-s", "4"], ("q3",), True),
    "version": ([], (), False),
}


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(root):
    """{relative path: bytes} of every file below `root` (or of `root`)."""
    if os.path.isfile(root):
        with open(root, "rb") as f:
            return {".": f.read()}
    out = {}
    for r, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(r, n), "rb") as f:
                out[os.path.relpath(os.path.join(r, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def inputs(golden_dir, tmp_path_factory):
    """A 60-entry target DB, a 40-entry version of it and 3 queries grown from
    the fixture structures; foldseek_tpu's exhaustive result DB of the
    queries with backtraces, without, and its top hits; that DB as a flat
    TSV and zstd-compressed; a key mapping, the queries' names by key, an
    id list, a cluster TSV; the fixture PDBs in a tar; an indexed copy of
    the targets."""
    d = tmp_path_factory.mktemp("torch_file_verbs")
    sup = golden_dir / "msa" / "sup"
    base = create_db([str(p) for p in sorted(sup.glob("*.pdb"))]
                     + [str(golden_dir / "d1asha.fcz")], str(d / "base"))
    t60 = synth_db(base, 60, str(d / "t60"), seed=1)
    q3 = synth_db(base, 3, str(d / "q3"), seed=4)
    shutil.copytree(sup, d / "sup")
    shutil.copy(golden_dir / "d1asha.fcz", d)
    (d / "ids").write_text("".join(f"{k}\n" for k in t60.keys[::3])
                           + f"{t60.names[1]}\n")
    assert jmain(["createsubdb", str(d / "ids"), str(d / "t60"),
                  str(d / "t40"), *QUIET]) == 0
    (d / "keymap").write_text("".join(f"{k}\t{1000 + 2 * int(k)}\n"
                                      for k in list(t60.keys)[::2]))
    (d / "qnames").write_text("".join(f"{k}\t{n}\n"
                                      for k, n in zip(q3.keys, q3.names)))
    (d / "clu.tsv").write_text("".join(
        f"{t60.names[i - i % 4]}\t{t60.names[i]}\n" for i in range(40)))
    for name, extra in (("aln_bt", ["-a"]), ("aln", [])):
        assert jmain(["search", str(d / "q3"), str(d / "t60"), str(d / name),
                      str(d / f"tmp_{name}"), "--exhaustive-search", "1",
                      *extra, *QUIET]) == 0
    assert jmain(["filterdb", str(d / "aln_bt"), str(d / "aln_top"),
                  "--filter-column", "2", "--comparison-operator", "ge",
                  "--comparison-value", "200", *QUIET]) == 0
    with open(d / "aln_bt") as f:
        (d / "aln.tsv").write_text("".join(line for line in f
                                           if not line.startswith("#")))
    assert jmain(["compress", str(d / "aln_bt"), str(d / "aln.zst")]) == 0
    with tarfile.open(d / "sup.tar", "w") as tar:
        for p in sorted(sup.glob("*.pdb"))[:3]:
            tar.add(p, arcname=p.name)
    shutil.copytree(d / "t60", d / "t60_indexed")
    assert jmain(["createindex", str(d / "t60_indexed"), *QUIET]) == 0
    return d


def _run(main, argv, capsys):
    """(exit code, stdout) of one verb; a SystemExit counts as its code."""
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("verb", sorted(CASES))
def test_file_verb_matches_jax(inputs, tmp_path, capsys, verb):
    argv, copies, verbose = CASES[verb]
    name5 = jstorage.load_db(str(inputs / "t60")).names[5]
    got = {}
    for side, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir()
        for c in copies:
            shutil.copytree(inputs / c, d / c)
        args = [a.format(**{"in": inputs, "d": d, "name5": name5})
                for a in argv]
        rc, out = _run(main, [verb, *(QUIET if verbose else ()), *args],
                       capsys)
        got[side] = (rc, out, _tree(d))
    (jrc, jout, jtree), (prc, pout, ptree) = got["jax"], got["port"]
    assert jrc == prc == 0
    if verb == "version":
        number = re.compile(r"\b\d+\.\d+\.\d+\b")
        assert number.findall(pout) == number.findall(jout) != []
        return
    assert pout == jout
    assert sorted(ptree) == sorted(jtree)
    for name in jtree:
        assert ptree[name] == jtree[name], name
    assert jtree or jout or verb == "rmdb"


@pytest.mark.parametrize("verb", ["mvdb", "lndb", "appenddbtoindex",
                                  "renamedbkeys"])
def test_index_after_file_verb(inputs, tmp_path, verb):
    """Each package takes the index of an indexed DB after the verb exactly
    when the other does, and `search --gpu 1` over the result (the port on
    the CPU) prints the same m8."""
    src = tmp_path / "t60_indexed"
    shutil.copytree(inputs / "t60_indexed", src)
    db = str(tmp_path / "result")
    argv = {"mvdb": [str(src), db], "lndb": [str(src), db],
            "appenddbtoindex": [str(inputs / "q3"), str(src), "--id-list",
                                "500", *QUIET],
            "renamedbkeys": [str(inputs / "keymap"), str(src), db, *QUIET]}
    assert tmain([verb, *argv[verb]]) == 0
    if verb == "appenddbtoindex":
        db = str(src)
    takes = (jindex.load_index(jstorage.load_db(db)) is not None,
             tindex.load_index(tdbmod.load_db(db)) is not None)
    assert takes == (True, True)
    m8 = []
    for side, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        res = str(tmp_path / f"res_{side}")
        assert main(["search", str(inputs / "q3"), db, res,
                     str(tmp_path / f"tmp_{side}"), "--gpu", "1", "-a",
                     *QUIET, *extra]) == 0
        assert main(["convertalis", str(inputs / "q3"), db, res,
                     res + ".m8", *QUIET]) == 0
        with open(res + ".m8", "rb") as f:
            m8.append(f.read())
    assert m8[0] == m8[1] and m8[0]


def test_createindex_twice_rebuilds_the_index(inputs, tmp_path):
    """A second createindex of an indexed DB (here a linked copy of one)
    writes the index that one createindex writes, and leaves the linked
    source's index as it was. foldseek_tpu's second createindex reads the
    postings it is rewriting and fails (ROADMAP section 3)."""
    src = inputs / "t60_indexed"
    before = _tree(src / "index")
    linked = str(tmp_path / "linked")
    assert tmain(["lndb", str(src), linked]) == 0
    for _ in range(2):
        assert tmain(["createindex", linked, *QUIET]) == 0
    assert _tree(os.path.join(linked, "index")) == before
    assert _tree(src / "index") == before
    assert not any(os.path.samefile(os.path.join(linked, "index", n),
                                    src / "index" / n) for n in before)

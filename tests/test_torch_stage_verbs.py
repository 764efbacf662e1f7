"""The port's stage verbs on the CPU against foldseek_tpu's: `search/alp.py`
and swapresults, the clustering stage verbs (kmermatcher,
structurerescorediagonal, clust, mergeclusters, result2rbh,
mergeresultsbyset), the multimer stage verbs (expandmultimer, scoremultimer,
createmultimerreport), the MSA -> profile chain (result2msa, filtera3m,
msa2profile and the profile DB's search), clusterupdate, warmup and the
`base:` prefix. Each writes the same bytes as `python -m foldseek_tpu` on
the same inputs.

The chains run by hand do not give the bytes of their workflows, in either
package: the multimer chain's structurealign re-aligns with the search's
composition-bias scale where `multimersearch` uses 1.0, and the clustering
chain here is two steps of the stage verbs, not `cluster`'s linclust and
three-step cascade. So each chain is held port against JAX, stage by stage.

The two packages meet only through files. The port's k-mer prefilter must
not fork this process (it holds a live JAX client), hence
FOLDSEEK_TPU_FORK=0."""
import math
import os
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.search import alp as jalp
import chip_smoke as cs
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.cli import COMMANDS
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.db.storage import StructDBWriter
from foldseek_tpu_torch.search import alp as talp
from foldseek_tpu_torch.search.resultdb import read_result_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = ["-v", "1"]
ON_CPU = ["--device", "cpu"]


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


def _both(verb, out, argv, port_extra=(), same=True):
    """Run `verb` through each package's CLI; `argv` holds "{out}" where each
    side writes its own output, and "{side}" for an input a side made
    itself. Returns the two output paths; with `same` their bytes must be
    equal and not empty."""
    outs = []
    for side, main, extra in (("jax", jmain, ()), ("port", tmain, port_extra)):
        path = f"{out}_{side}"
        args = [verb] + [a.format(out=path, side=side) for a in argv] + QUIET
        assert main(args + list(extra)) == 0, (side, args)
        outs.append(path)
    if same and os.path.isfile(outs[0]):
        assert _read(outs[0]) == _read(outs[1])
        assert _read(outs[1]).strip()
    return outs


@pytest.fixture(scope="module")
def work(golden_dir, tmp_path_factory):
    """A 60-entry target DB and 3 queries grown from the 17 fixture
    structures by db/synth.py; JAX-written exhaustive result DBs of the
    queries against the targets (with and without backtraces) and of the
    queries against themselves (with)."""
    d = tmp_path_factory.mktemp("torch_stage_verbs")
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    base = create_db(inputs, str(d / "base"))
    synth_db(base, 60, str(d / "t60"), seed=1)
    synth_db(base, 3, str(d / "q3"), seed=4)
    paths = {k: str(d / k) for k in ("base", "t60", "q3")}
    for name, q, extra in (("aln_bt", "q3", ["-a"]), ("aln", "q3", []),
                           ("self_bt", "q3", ["-a"])):
        paths[name] = str(d / name)
        t = paths["q3"] if name == "self_bt" else paths["t60"]
        assert jmain(["search", paths[q], t, paths[name], str(d / f"tmp_{name}"),
                      "--exhaustive-search", "1", *extra, *QUIET]) == 0
    paths["dir"] = str(d)
    return paths


# --- search/alp.py and swapresults --------------------------------------------

def test_alp_evaluer_matches_jax():
    """The pinned Gumbel fit and every number of AlpEvaluer are those of
    foldseek_tpu's, to the last bit, on a grid of bit scores x lengths x DB
    sizes (underflow to 0 included)."""
    assert astuple(talp.MAT3DI_GAP_10_1) == astuple(jalp.MAT3DI_GAP_10_1)
    n = 0
    for db_res in (1.0, 5_000.0, 123_456.0, 3.2e9):
        t, j = talp.AlpEvaluer(db_res), jalp.AlpEvaluer(db_res)
        for bits in (-5.0, 0.0, 1.0, 10.0, 33.3, 50.0, 100.0, 300.0, 1000.0):
            raw = t.raw_score_from_bit_score(bits)
            assert raw == j.raw_score_from_bit_score(bits)
            for length in (1.0, 7.0, 30.0, 120.0, 250.0, 1000.0, 40_000.0):
                got = (t.area(raw, length), t.compute_evalue(raw, length),
                       t.swapped_evalue(bits, length))
                assert got == (j.area(raw, length),
                               j.compute_evalue(raw, length),
                               j.swapped_evalue(bits, length))
                assert all(math.isfinite(x) for x in got)
                n += 1
    assert n == 4 * 9 * 7


@pytest.mark.parametrize("result", ["aln_bt", "aln"])
def test_swapresults_matches_jax(work, tmp_path, result):
    """swapresults (and swapdb) with and without backtraces; swapping twice
    gives back the original records (keys, scores, starts)."""
    q, t = work["q3"], work["t60"]
    once = _both("swapresults", str(tmp_path / "sw1"),
                 [q, t, work[result], "{out}"])
    twice = _both("swapdb", str(tmp_path / "sw2"), [t, q, once[1], "{out}"])
    orig, _ = read_result_db(work[result])
    back, _ = read_result_db(twice[1])

    def records(res):
        return {(qk, r.db_key, r.score, r.q_start, r.t_start, r.backtrace)
                for qk, rs in res.items() for r in rs}
    assert records(back) == records(orig) and len(records(orig)) > 20


# --- the clustering stage verbs -----------------------------------------------

@pytest.fixture(scope="module")
def lin(work):
    """kmermatcher of the 60 targets (JAX) as a result DB, and its
    structurerescorediagonal (JAX): the linclust stage's pairs."""
    d, t = work["dir"], work["t60"]
    assert jmain(["kmermatcher", t, os.path.join(d, "kmer.tsv"), *QUIET]) == 0
    pref = cs.kmer_tsv_as_result_db(os.path.join(d, "kmer.tsv"),
                                    tdbmod.load_db(t),
                                    os.path.join(d, "kmer_res"))
    rescored = os.path.join(d, "rescored")
    assert jmain(["structurerescorediagonal", t, t, pref, rescored,
                  *QUIET]) == 0
    return dict(pref=pref, rescored=rescored)


@pytest.mark.parametrize("extra", [[], ["-k", "10", "--kmers-per-sequence",
                                        "40"]])
def test_kmermatcher_matches_jax(work, tmp_path, extra):
    outs = _both("kmermatcher", str(tmp_path / "kmer"),
                 [work["t60"], "{out}", *extra])
    assert _read(outs[1]).count(b"\n") >= 60


@pytest.mark.parametrize("source", ["kmermatcher", "search"])
def test_structurerescorediagonal_matches_jax(work, lin, tmp_path, source):
    """Over kmermatcher's pairs (the DB against itself) and over a search
    result (queries against targets)."""
    if source == "kmermatcher":
        argv = [work["t60"], work["t60"], lin["pref"], "{out}"]
    else:
        argv = [work["q3"], work["t60"], work["aln"], "{out}",
                "--min-diag-score", "10"]
    outs = _both("structurerescorediagonal", str(tmp_path / "rescored"), argv)
    assert _read(outs[1]).count(b"\n") > 20


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_clust_matches_jax(work, lin, tmp_path, mode):
    """clust in every --cluster-mode over the rescored linclust pairs."""
    outs = _both("clust", str(tmp_path / "clu"),
                 [work["t60"], lin["rescored"], "{out}", "--cluster-mode",
                  str(mode)])
    assert _read(outs[1]).count(b"\n") == 60


def test_clustering_chain_and_mergeclusters_match_jax(work, lin, tmp_path):
    """Two cascade steps by hand, each package on its own outputs: clust of
    the rescored linclust pairs; structurealign -a of those pairs (the SW
    kernel's plain version on the port's side) and clust of that; then
    mergeclusters of the two steps."""
    t, d = work["t60"], str(tmp_path)
    step1 = _both("clust", f"{d}/step1", [t, lin["rescored"], "{out}"])
    aln = _both("structurealign", f"{d}/aln",
                [t, t, lin["rescored"], "{out}", "-a"], ON_CPU)
    step2 = _both("clust", f"{d}/step2", [t, f"{d}/aln_{{side}}", "{out}",
                                          "--cluster-mode", "2"])
    for side, s1, s2 in zip(("jax", "port"), step1, step2):
        cs.cluster_tsv_as_keys(s1, tdbmod.load_db(t), f"{d}/keys1_{side}")
        cs.cluster_tsv_as_keys(s2, tdbmod.load_db(t), f"{d}/keys2_{side}")
    merged = _both("mergeclusters", f"{d}/merged",
                   [f"{d}/keys1_{{side}}", f"{d}/keys2_{{side}}", "{out}"])
    members = [int(line.split("\t")[1])
               for line in _read(merged[1]).decode().splitlines()]
    assert sorted(members) == list(range(60))
    assert _read(aln[1]).count(b"\n") > 60


def test_result2rbh_matches_jax(work, tmp_path):
    outs = _both("result2rbh", str(tmp_path / "rbh"), [work["aln"], "{out}"],
                 same=False)
    assert _read(outs[0]) == _read(outs[1])


def test_mergeresultsbyset_matches_jax(work, tmp_path):
    """Each target key stands for a set of three members (keys 100 k ...)."""
    sets = tmp_path / "sets.tsv"
    sets.write_text("".join(f"{k}\t{100 * k + j}\n" for k in range(0, 60, 2)
                            for j in range(3)))
    for result in ("aln", "aln_bt"):
        _both("mergeresultsbyset", str(tmp_path / result),
              [work[result], str(sets), "{out}"])


# --- the multimer stage verbs -------------------------------------------------

@pytest.fixture(scope="module")
def complexes(work):
    """80 synthetic targets and 8 queries, their fileids grouping entries
    two by two into complexes."""
    out = {}
    base = tdbmod.load_db(work["base"])
    for name, n, seed in (("ct80", 80, 1), ("cq8", 8, 4)):
        path = out[name] = os.path.join(work["dir"], name)
        tdbmod.synth_db(base, n, path, seed=seed)
        np.save(os.path.join(path, "fileids.npy"),
                (np.arange(n) // 2).astype(np.uint32))
    return out


def test_multimer_chain_matches_jax(complexes, tmp_path):
    """search --gpu 1 -> expandmultimer -> structurealign -a -e 10000 ->
    scoremultimer (without and with thresholds) -> createmultimerreport,
    each package on its own outputs, every stage's bytes equal."""
    q, t, d = complexes["cq8"], complexes["ct80"], str(tmp_path)
    _both("search", f"{d}/s", [q, t, "{out}", f"{d}/tmp_{{side}}",
                              "--gpu", "1"], ON_CPU)
    _both("expandcomplex", f"{d}/ex", [q, t, f"{d}/s_{{side}}", "{out}"])
    _both("structurealign", f"{d}/sa", [q, t, f"{d}/ex_{{side}}", "{out}",
                                        "-a", "-e", "10000"], ON_CPU)
    scored = _both("scoremultimer", f"{d}/sc",
                   [q, t, f"{d}/sa_{{side}}", "{out}"])
    assert _read(scored[1]).startswith(b"#foldseek-tpu complexres")
    _both("scorecomplex", f"{d}/scf", [q, t, f"{d}/sa_{{side}}", "{out}",
                                       "--multimer-tm-threshold", "0.5",
                                       "--chain-tm-threshold", "0.3"])
    report = _both("createmultimerreport", f"{d}/rep",
                   [q, t, f"{d}/sc_{{side}}", "{out}"])
    assert _read(report[1]).count(b"\n") >= 4
    _both("createcomplexreport", f"{d}/repf", [q, t, f"{d}/scf_{{side}}",
                                               "{out}"], same=False)
    assert _read(f"{d}/repf_jax") == _read(f"{d}/repf_port")


def test_scoremultimer_needs_backtraces(complexes, work):
    """Both packages refuse an alignment DB without backtraces (exit 1)."""
    argv = ["scoremultimer", work["q3"], work["t60"], work["aln"],
            os.path.join(work["dir"], "never"), *QUIET]
    assert jmain(argv) == 1 and tmain(argv) == 1


# --- the MSA -> profile chain -------------------------------------------------

@pytest.mark.parametrize("mode", [2, 3, 5, 6])
@pytest.mark.parametrize("result", ["aln_bt", "self_bt"])
def test_result2msa_matches_jax(work, tmp_path, mode, result):
    """Every MSA format over the queries' hits among the targets, and over
    the queries against themselves (the self hit left to the center row)."""
    t = work["q3"] if result == "self_bt" else work["t60"]
    _both("result2msa", str(tmp_path / "msa"),
          [work["q3"], t, work[result], "{out}", "--msa-format-mode",
           str(mode)])


def test_result2msa_skip_query_and_refusals(work, tmp_path):
    _both("result2msa", str(tmp_path / "msa"),
          [work["q3"], work["t60"], work["aln_bt"], "{out}", "--skip-query",
           "1"])
    for main in (jmain, tmain):
        for argv in ([work["aln"]], [work["aln_bt"], "--msa-format-mode", "4"]):
            with pytest.raises(SystemExit):
                main(["result2msa", work["q3"], work["t60"], argv[0],
                      str(tmp_path / "never"), *argv[1:], *QUIET])


@pytest.fixture(scope="module")
def msas(work):
    """JAX's result2msa of the queries' hits: aligned FASTA and A3M."""
    out = {}
    for mode in (2, 5):
        out[mode] = os.path.join(work["dir"], f"msa{mode}")
        assert jmain(["result2msa", work["q3"], work["t60"], work["aln_bt"],
                      out[mode], "--msa-format-mode", str(mode), *QUIET]) == 0
    return out


@pytest.mark.parametrize("mode", [2, 5])
def test_filtera3m_matches_jax(msas, tmp_path, mode):
    outs = _both("filtera3m", str(tmp_path / "filtered"), [msas[mode], "{out}"])
    assert _read(outs[1]).count(b"#entry ") == 3
    assert len(_read(outs[1])) <= len(_read(msas[mode]))


MSA2PROFILE_CASES = {
    "fasta_seqdb": (2, ["--seq-db", "{q3}"]),
    "a3m_seqdb": (5, ["--seq-db", "{q3}"]),
    "no_seqdb": (2, []),
    "match_mode1_unfiltered": (5, ["--match-mode", "1", "--match-ratio",
                                   "0.3", "--filter-msa", "0"]),
}


@pytest.mark.parametrize("case", sorted(MSA2PROFILE_CASES))
def test_msa2profile_matches_jax(work, msas, tmp_path, case):
    mode, extra = MSA2PROFILE_CASES[case]
    extra = [a.format(q3=work["q3"]) for a in extra]
    outs = _both("msa2profile", str(tmp_path / "prof"),
                 [msas[mode], "{out}", *extra])
    assert len(_same_tree(*outs)) >= 2


def test_msa2profile_search_matches_jax(work, msas, tmp_path):
    """msa2profile --seq-db, then `search` of the profile DB on the targets
    (-a) and on the queries, each package on its own profile DB: the same
    result DB bytes; against the queries every profile's top hit is its own
    source."""
    d = str(tmp_path)
    _both("msa2profile", f"{d}/prof", [msas[2], "{out}", "--seq-db",
                                       work["q3"]])
    outs = _both("search", f"{d}/res", [f"{d}/prof_{{side}}", work["t60"],
                                        "{out}", f"{d}/tmp_{{side}}", "-a"],
                 ON_CPU)
    assert _read(outs[1]).count(b"\n") > 20
    outs = _both("search", f"{d}/self", [f"{d}/prof_{{side}}", work["q3"],
                                         "{out}", f"{d}/tmps_{{side}}"],
                 ON_CPU)
    res, _ = read_result_db(outs[1])
    assert sorted(res) == [0, 1, 2]
    assert all(rs and rs[0].db_key == qk for qk, rs in res.items())


# --- clusterupdate, warmup, base: ---------------------------------------------

@pytest.fixture(scope="module")
def update(work, golden_dir):
    """The 60 targets clustered by JAX's easy-cluster (the old clustering);
    a new DB without one representative and one member of a cluster of
    several, with two entries added: a crop of the fixture structures and
    an unrelated random chain."""
    d = work["dir"]
    prefix = os.path.join(d, "oldclu")
    assert jmain(["easy-cluster", work["t60"], prefix, os.path.join(
        d, "oldclu_tmp"), *QUIET]) == 0
    pairs = [line.split("\t") for line in
             open(prefix + "_cluster.tsv").read().splitlines()]
    big = max({r for r, _ in pairs}, key=lambda r: sum(x == r for x, _ in pairs))
    member = next(m for r, m in pairs if r == big and m != big)
    crop = tdbmod.synth_db(tdbmod.load_db(work["base"]), 1,
                           os.path.join(d, "crop"), seed=7)
    rng = np.random.default_rng(3)
    steps = rng.normal(size=(90, 3))
    w = StructDBWriter(os.path.join(d, "extra"))
    w.add_entry(0, "crop", "crop", np.asarray(crop.get_aa(0)),
                np.asarray(crop.get_ss(0)), np.asarray(crop.get_ca(0)))
    w.add_entry(1, "rnd", "rnd", rng.integers(0, 20, 90).astype(np.int8),
                rng.integers(0, 20, 90).astype(np.int8),
                np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=1,
                                                       keepdims=True),
                          axis=0).astype(np.float32))
    old = tdbmod.load_db(work["t60"])
    drop = {i for i in range(old.size) if old.names[i] in (big, member)}
    new = cs.updated_db(old, w.finish(), drop, os.path.join(d, "t60_new"))
    return dict(tsv=prefix + "_cluster.tsv", new=new.path, dropped={big, member})


def test_clusterupdate_matches_jax(work, update, tmp_path):
    """The new clustering TSV equals foldseek_tpu's: the removed entries
    are gone and every entry of the new DB is placed exactly once."""
    outs = _both("clusterupdate", str(tmp_path / "new"),
                 [work["t60"], update["new"], update["tsv"], "{out}",
                  str(tmp_path / "tmp_{side}")], ON_CPU)
    members = [line.split("\t")[1]
               for line in _read(outs[1]).decode().splitlines()]
    new = tdbmod.load_db(update["new"])
    assert sorted(members) == sorted(new.names) and len(members) == 60
    assert not update["dropped"] & set(members)
    # the random chain joins no cluster: step 4 makes it one of its own
    assert b"upd0000001\tupd0000001\n" in _read(outs[1])


def test_warmup_on_cpu_runs_both_modes_without_jax(work):
    """warmup --device cpu in a process of its own: exit 0, the k-mer and
    the gapless search both ran, and nothing of jax was imported."""
    code = ("import sys; from foldseek_tpu_torch.cli import main; "
            f"rc = main(['warmup', {work['t60']!r}, '--device', 'cpu', "
            "'--query-lengths', '60,150']); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'foldseek_tpu.'))]; "
            "sys.exit(rc or (3 if bad else 0))")
    env = dict(os.environ, PYTHONPATH=REPO, FOLDSEEK_TPU_FORK="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "warmup: k-mer-mode search ran" in proc.stderr
    assert "warmup: gapless-mode search ran" in proc.stderr


def test_warmup_refuses_cuda_without_a_card(work):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(Exception):
        tmain(["warmup", work["t60"], *QUIET])


def test_base_prefix_dispatches_like_jax(work, lin, tmp_path):
    """`base:<verb>` runs the verb, in both packages; an unknown name exits
    1."""
    _both("base:clust", str(tmp_path / "clu"),
          [work["t60"], lin["rescored"], "{out}"])
    _both("base:swapdb", str(tmp_path / "sw"),
          [work["q3"], work["t60"], work["aln"], "{out}"])
    assert tmain(["base:nosuchverb"]) == 1 and jmain(["base:nosuchverb"]) == 1
    assert len(COMMANDS) == 96

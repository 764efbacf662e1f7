"""The port's clustering workflows on the CPU (plain PyTorch versions of the
kernels) against foldseek_tpu: the clustering algorithms, the linclust
stages (kmermatcher, structurerescorediagonal), `cluster_db` with and
without the cascade, easy-cluster's three files, the stage resume,
cluster-search and easy-rbh, all exact.

The two packages meet only through files and plain values: a DB directory
written by one side is loaded by each side's own `load_db`. The port's k-mer
prefilter must not fork this process (it holds a live JAX client), hence
FOLDSEEK_TPU_FORK=0."""
import shutil

import numpy as np
import pytest
import torch

from foldseek_tpu.cli import main as jmain
from foldseek_tpu.cluster import clust as jclust
from foldseek_tpu.cluster import kmermatcher as jkm
from foldseek_tpu.cluster import rescorediagonal as jrescore
from foldseek_tpu.cluster import workflow as jwf
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import rbh as jrbh
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.cluster import clust as tclust
from foldseek_tpu_torch.cluster import kmermatcher as tkm
from foldseek_tpu_torch.cluster import rescorediagonal as trescore
from foldseek_tpu_torch.cluster import workflow as twf
from foldseek_tpu_torch.search import (SearchParams, format_results,
                                       reset_stage_times,
                                       snapshot_stage_counts,
                                       snapshot_stage_times)
from foldseek_tpu_torch.search import rbh as trbh
from foldseek_tpu_torch.utils.log import record_count

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


def _fixture_inputs(golden_dir):
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """150 entries expanded by db/synth.py from the 17 fixture structures,
    3 queries and 40 entries for rbh's reverse search; each package loads
    the same directories."""
    d = tmp_path_factory.mktemp("torch_cluster")
    base = create_db(_fixture_inputs(golden_dir), str(d / "base"))
    synth_db(base, 150, str(d / "s150"), seed=2)
    synth_db(base, 3, str(d / "q3"), seed=4)
    synth_db(base, 40, str(d / "s40"), seed=5)
    return {side: (load(str(d / "s150")), load(str(d / "q3")),
                   load(str(d / "s40")))
            for side, load in (("jax", jstorage.load_db),
                               ("port", tdbmod.load_db))}


def _random_edges(rng, keys, n_edges):
    """query key -> AlnEdge lists of a seeded random graph; some entries have
    no lines (the implicit self edge), scores include the unsigned-short
    range read through a signed short by set-cover."""
    edges = {}
    for _ in range(n_edges):
        q, t = (int(k) for k in rng.choice(keys, 2))
        edges.setdefault(q, []).append((t, int(rng.choice(
            [rng.integers(0, 1001), 65535, 40000]))))
    return edges


@pytest.mark.parametrize("mode", [tclust.MODE_SET_COVER,
                                  tclust.MODE_CONNECTED_COMPONENT,
                                  tclust.MODE_GREEDY, tclust.MODE_GREEDY_MEM])
@pytest.mark.parametrize("seed", [0, 1])
def test_clust_matches_jax(mode, seed):
    """`clust.cluster` in every mode on seeded random edge sets: identical
    (rep, member) pairs and grouped clusters."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(400)[:120].astype(np.int64)
    lens = rng.integers(30, 60, len(keys))    # many ties in length
    raw = _random_edges(rng, keys, 150)
    args = [(keys, lens, {q: [m.AlnEdge(t, s) for t, s in lines]
                          for q, lines in raw.items()}, mode, 3)
            for m in (jclust, tclust)]
    want = jclust.cluster(*args[0])
    got = tclust.cluster(*args[1])
    assert got == want and len({r for r, _ in got}) > 5
    assert tclust.pairs_to_clusters(got) == jclust.pairs_to_clusters(want)


def test_length_sort_order_matches_jax():
    rng = np.random.default_rng(5)
    keys = rng.permutation(1000)[:300].astype(np.uint32)
    lens = rng.integers(10, 20, 300)
    got = tclust.length_sort_order(keys, lens)
    assert np.array_equal(got, jclust.length_sort_order(keys, lens))
    assert np.all(np.diff(lens[got]) <= 0)


@pytest.fixture(scope="module")
def kmer_hits(dbs):
    jdb, tdb = dbs["jax"][0], dbs["port"][0]
    want = jkm.kmermatcher(jdb, jkm.KmerMatcherParams(
        kmers_per_sequence=300, spaced_kmer=True))
    got = tkm.kmermatcher(tdb, tkm.KmerMatcherParams(
        kmers_per_sequence=300, spaced_kmer=True))
    return got, want


def test_kmermatcher_matches_jax(kmer_hits):
    got, want = kmer_hits
    assert got == want
    assert sum(len(v) > 1 for v in got.values()) > 5


def test_rescore_all_matches_jax(dbs, kmer_hits):
    """structurerescorediagonal records of the kmermatcher's hits, field by
    field (including the reverse-pass quirk on negative diagonals)."""
    pref, _ = kmer_hits
    hits = {k: [(t, d) for t, _s, d in lines] for k, lines in pref.items()}
    assert any(d < 0 for lines in hits.values() for _t, d in lines)
    kw = dict(cov_thr=0.8, evalue_thr=0.01, comp_bias_correction=False,
              sort_by_structure_bits=False, include_identity=True)
    want = jrescore.rescore_all(dbs["jax"][0], dbs["jax"][0], hits,
                                jparams.SearchParams(**kw), same_db=True)
    got = trescore.rescore_all(dbs["port"][0], dbs["port"][0], hits,
                               SearchParams(**kw), same_db=True)
    assert list(got) == list(want)
    assert {k: [vars(r) for r in v] for k, v in got.items()} == \
        {k: [vars(r) for r in v] for k, v in want.items()}
    assert sum(len(v) for v in got.values()) > 150


@pytest.mark.parametrize("single_step", [False, True])
def test_cluster_db_matches_jax(dbs, single_step):
    """`cluster_db` with the default parameters: the linclust stage alone
    (single step) and with the three-step cascade."""
    want = jwf.cluster_db(dbs["jax"][0],
                          jwf.ClusterParams(single_step=single_step))
    got = twf.cluster_db(dbs["port"][0],
                         twf.ClusterParams(single_step=single_step), CPU)
    assert got == want
    assert 1 < len(got) < dbs["port"][0].size


def test_cluster_db_resumes(dbs, tmp_path, caplog, monkeypatch):
    """A second run over the same tmp dir logs the resume of every stage,
    aligns nothing and returns the same clusters."""
    db = dbs["port"][0]
    params = twf.ClusterParams(cluster_steps=2)
    reset_stage_times()
    first = twf.cluster_db(db, params, CPU, tmp_dir=str(tmp_path))
    # the lin stage and two cascade steps, each one align_all call
    counts = snapshot_stage_counts()
    assert len(counts["align_pairs"]) == 3 and counts["align_pairs"][0] > 0
    monkeypatch.setattr(twf, "align_all",
                        lambda *a, **k: pytest.fail("an align stage ran"))
    reset_stage_times()
    with caplog.at_level("INFO", logger="foldseek_tpu_torch"):
        again = twf.cluster_db(db, params, CPU, tmp_dir=str(tmp_path))
    assert again == first
    assert snapshot_stage_counts() == {}
    resumed = [r.getMessage() for r in caplog.records
               if "resume: skipping" in r.getMessage()]
    assert len(resumed) == 4, resumed   # clu_pre, clu_lin, clu_step0/1


def test_stage_counts_accumulate_per_call():
    """record_count keeps one number a call under its label, in call order,
    and reset_stage_times clears the counts with the times."""
    reset_stage_times()
    record_count("align_pairs", 3)
    record_count("align_pairs", 0)
    record_count("panel_set_entries", 7)
    got = snapshot_stage_counts()
    assert got == {"align_pairs": [3, 0], "panel_set_entries": [7]}
    got["align_pairs"].append(1)     # a snapshot is a copy
    assert snapshot_stage_counts()["align_pairs"] == [3, 0]
    reset_stage_times()
    assert snapshot_stage_counts() == {} and snapshot_stage_times() == {}


def test_subdb_view_keeps_key_order(dbs):
    """createsubdb --subdb-mode 1: the view holds the asked keys in
    ascending order with their residues, under the parent's path."""
    db = dbs["port"][0]
    keys = [140, 3, 77, 12]
    sub = twf._subdb_view(db, keys)
    assert [int(k) for k in sub.keys] == sorted(keys) and sub.path == db.path
    kti = db.key_to_index()
    for j, k in enumerate(sorted(keys)):
        assert sub.get_aa_str(j) == db.get_aa_str(kti[k])
        assert np.array_equal(sub.get_ca(j), db.get_ca(kti[k]))


def test_easy_cluster_cli_matches_jax(golden_dir, tmp_path):
    """easy-cluster from structure files: `_cluster.tsv`, `_rep_seq.fasta`
    and `_all_seqs.fasta` byte for byte."""
    inputs = _fixture_inputs(golden_dir)
    assert jmain(["easy-cluster", *inputs, str(tmp_path / "jax"),
                  str(tmp_path / "tmp_jax"), "-v", "1"]) == 0
    assert tmain(["easy-cluster", *inputs, str(tmp_path / "port"),
                  str(tmp_path / "tmp_port"), "--device", "cpu",
                  "-v", "1"]) == 0
    for suffix in ("_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta"):
        want = (tmp_path / f"jax{suffix}").read_bytes()
        assert (tmp_path / f"port{suffix}").read_bytes() == want, suffix
        assert want


def test_cluster_cli_on_a_db_matches_jax(dbs, tmp_path):
    """`cluster` on a prebuilt DB writes the same JSON as foldseek_tpu."""
    path = dbs["port"][0].path
    assert jmain(["cluster", path, str(tmp_path / "jax.json"),
                  str(tmp_path / "tmp_jax"), "--single-step-clustering",
                  "-v", "1"]) == 0
    assert tmain(["cluster", path, str(tmp_path / "port.json"),
                  str(tmp_path / "tmp_port"), "--single-step-clustering",
                  "--device", "cpu", "-v", "1"]) == 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_cluster_search_matches_jax(dbs, tmp_path):
    """createclusearchdb from a clustering of the 150 entries, then
    `search --cluster-search 1 --gpu 1`: the m8 of the expanded, re-aligned
    hits against the `_seq` DB is the same on both sides."""
    path = dbs["port"][0].path
    qpath = dbs["port"][1].path
    clusters = twf.cluster_db(dbs["port"][0],
                              twf.ClusterParams(single_step=True), CPU)
    tsv = tmp_path / "clu.tsv"
    twf.write_cluster_tsv(dbs["port"][0], clusters, str(tsv))
    for side, run in (("jax", jmain), ("port", tmain)):
        assert run(["createclusearchdb", path, str(tsv),
                    str(tmp_path / f"{side}_clu"), "-v", "1"]) == 0
    for suffix in ("_clu.tsv", "/keys.npy", "_seq/keys.npy"):
        assert (tmp_path / f"port_clu{suffix}").read_bytes() == \
            (tmp_path / f"jax_clu{suffix}").read_bytes()
    common = ["--cluster-search", "1", "--gpu", "1", "-v", "1"]
    assert jmain(["search", qpath, str(tmp_path / "jax_clu"),
                  str(tmp_path / "jax_aln"), str(tmp_path / "tmp_jax"),
                  *common]) == 0
    assert jmain(["convertalis", qpath, str(tmp_path / "jax_clu"),
                  str(tmp_path / "jax_aln"), str(tmp_path / "jax.m8"),
                  "-v", "1"]) == 0
    assert tmain(["search", qpath, str(tmp_path / "port_clu"),
                  str(tmp_path / "port_aln"), str(tmp_path / "tmp_port"),
                  *common, "--device", "cpu"]) == 0
    assert (tmp_path / "port_aln").read_bytes() == \
        (tmp_path / "jax_aln").read_bytes()
    from foldseek_tpu_torch.search.resultdb import read_result_db
    res, has_bt = read_result_db(str(tmp_path / "port_aln"))
    seq_db = tdbmod.load_db(str(tmp_path / "port_clu") + "_seq")
    lines = format_results(dbs["port"][1], seq_db, res,
                           SearchParams().format_output, with_backtrace=has_bt)
    want = (tmp_path / "jax.m8").read_text().splitlines()
    assert lines == want
    # hits reach members that are not representatives
    reps = {int(r) for r in clusters}
    names = {seq_db.names[i]: int(k) for i, k in enumerate(seq_db.keys)}
    assert any(names[ln.split("\t")[1]] not in reps for ln in lines)


def test_easy_rbh_matches_jax(dbs, tmp_path):
    """easy-rbh, A = 3 queries, B = 40 entries, --gpu 1: the same
    reciprocal best hit lines; the `rbh` verb on the two DBs writes the same
    result DB."""
    qpath, tpath = dbs["port"][1].path, dbs["port"][2].path
    want = jrbh.easy_rbh(qpath, tpath, str(tmp_path / "jax.m8"),
                         str(tmp_path / "tmp_jax"),
                         jparams.SearchParams(prefilter_mode=1))
    assert tmain(["easy-rbh", qpath, tpath, str(tmp_path / "port.m8"),
                  str(tmp_path / "tmp_port"), "--gpu", "1", "--device", "cpu",
                  "-v", "1"]) == 0
    assert (tmp_path / "port.m8").read_text().splitlines() == want
    assert len(want) >= 1
    for side, run, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        assert run(["rbh", qpath, tpath, str(tmp_path / f"{side}_aln"),
                    str(tmp_path / f"{side}_tmp2"), "--gpu", "1", "-v", "1",
                    *extra]) == 0
    assert (tmp_path / "port_aln").read_bytes() == \
        (tmp_path / "jax_aln").read_bytes()


# --- the JAX package's golden tests, for the port -----------------------------

@pytest.fixture(scope="module")
def scop_dir(example_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scop")
    for f in example_dir.iterdir():
        if "tim" not in f.name:
            shutil.copy(f, d / f.name)
    return d


def test_port_easy_cluster_scop_golden(scop_dir, golden_dir, tmp_path):
    """Cluster assignments on the 26 SCOP domains equal the reference's
    easy-cluster output (rep -> member sets)."""
    prefix = str(tmp_path / "clu")
    assert tmain(["easy-cluster", str(scop_dir), prefix, str(tmp_path / "tmp"),
                  "--device", "cpu", "-v", "1"]) == 0

    def read_clusters(path):
        clusters = {}
        for line in open(path):
            rep, member = line.rstrip("\n").split("\t")
            clusters.setdefault(rep, set()).add(member)
        return clusters
    assert read_clusters(prefix + "_cluster.tsv") == \
        read_clusters(golden_dir / "scop_clu_cluster.tsv")


def test_port_easy_rbh_golden(example_dir, golden_dir, tmp_path):
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir()
    b_dir.mkdir()
    domains = sorted(f for f in example_dir.iterdir() if "tim" not in f.name)
    for i, f in enumerate(domains):
        shutil.copy(f, (b_dir if i % 2 == 0 else a_dir) / f.name)
    lines = trbh.easy_rbh(str(a_dir), str(b_dir), str(tmp_path / "rbh.m8"),
                          str(tmp_path / "tmp"), SearchParams(), CPU)
    assert lines == [ln.rstrip("\n") for ln in open(golden_dir / "rbh.m8")]


def test_port_cluster_search_golden(example_dir, golden_dir, scop_dir,
                                    tmp_path):
    from foldseek_tpu_torch.search.resultdb import read_result_db
    scopdb = tdbmod.create_db([str(scop_dir)], str(tmp_path / "scopdb"))
    cludb = str(tmp_path / "cludb")
    assert tmain(["createclusearchdb", scopdb.path,
                  str(golden_dir / "scop_refclu.tsv"), cludb, "-v", "1"]) == 0
    qdb = tdbmod.create_db([str(example_dir / "d1asha_")], str(tmp_path / "qdb"))
    aln = str(tmp_path / "aln")
    assert tmain(["search", qdb.path, cludb, aln, str(tmp_path / "tmp"),
                  "--cluster-search", "1", "--device", "cpu", "-v", "1"]) == 0
    res, has_bt = read_result_db(aln)
    lines = format_results(qdb, tdbmod.load_db(cludb + "_seq"), res,
                           SearchParams().format_output, with_backtrace=has_bt)
    assert "\n".join(lines) + "\n" == (golden_dir / "clusearch.m8").read_text()

"""The port's search path on CPU tensors (plain PyTorch versions of the
kernels) against foldseek_tpu: prefilter candidate lists and m8 bytes are
identical; the CLI, import hygiene and the unported modes behave.

The two packages meet only through files and plain values: a DB directory
written by one side is loaded by each side's own `load_db`, and each side
gets its own `SearchParams`."""
import ast
import json
import os
import shutil
import subprocess
import sys
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.search import convertalis as jconv
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipe
from foldseek_tpu.search import ungapped as jung
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.db.panels import TorchPanelSet, resident_panels
from foldseek_tpu_torch.device import get_device
from foldseek_tpu_torch.search import SearchParams, format_results
from foldseek_tpu_torch.search import pipeline as tpipe
from foldseek_tpu_torch.search import ungapped as tung

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GPU_KW = dict(prefilter_mode=1, add_backtrace=True)
M8 = SearchParams().format_output


class Side:
    """One package's view of the fixture DB directories."""

    def __init__(self, load_db, tdir, qdir):
        self.tdb, self.qdb = load_db(tdir), load_db(qdir)


def _fixture_inputs(golden_dir):
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """17 C-alpha-only / Foldcomp entries expanded to 600 targets and 4
    queries by db/synth.py."""
    d = tmp_path_factory.mktemp("torch_search")
    base = create_db(_fixture_inputs(golden_dir), str(d / "base"))
    synth_db(base, 600, str(d / "t600"), seed=1)
    synth_db(base, 4, str(d / "q4"), seed=4)
    dirs = (str(d / "t600"), str(d / "q4"))
    return Side(jstorage.load_db, *dirs), Side(tdbmod.load_db, *dirs)


@pytest.fixture(scope="module")
def jax_prefilter_hits(dbs):
    jax_side, _ = dbs
    tdb, qdb = jax_side.tdb, jax_side.qdb
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    seqs.append(np.asarray(tdb.get_ss(5)))   # a query that is also a target
    return seqs, jung.UngappedPrefilter(tdb).query_batch(
        seqs, jparams.SearchParams())


@pytest.mark.parametrize("mode", ["whole", "split", "device_topk"])
def test_prefilter_candidates_match_jax(dbs, jax_prefilter_hits, mode,
                                        monkeypatch):
    tdb = dbs[1].tdb
    seqs, want = jax_prefilter_hits
    params = SearchParams()
    budget = None
    if mode == "split":
        total = tung.UngappedPrefilter(tdb, CPU).panels.total_bytes
        budget = max(total // 4, 128 * 128)
    pref = tung.UngappedPrefilter(tdb, CPU, budget_bytes=budget)
    if mode == "split":
        assert len(pref.panels.splits) >= 3
    if mode == "device_topk":
        # every piece takes the per-piece top-k; the host list is then the
        # first max_seqs of the full sorted list
        monkeypatch.setattr(tung, "DEVICE_TOPK_MIN_ROWS", 0)
        params = replace(params, max_seqs=40)
        want = [w[:40] for w in want]
    got = pref.query_batch(seqs, params)
    assert got == want
    assert all(len(w) > 3 for w in want)


def test_panels_from_numpy_keep_and_release(dbs):
    """The port's own buckets and split plan equal foldseek_tpu's, array by
    array; a kept panel stays resident, a streamed one is released."""
    from foldseek_tpu.db.panels import PanelSet
    jax_side, port_side = dbs
    ps = PanelSet.from_db(jax_side.tdb, None, use_index=False)
    tp = TorchPanelSet(port_side.tdb, CPU)
    def plan(splits):
        return [[(p.bucket, p.row_start, p.row_end) for p in split]
                for split in splits]
    assert plan(tp.splits) == plan(ps.splits)
    assert len(tp.buckets) == len(ps.buckets) and tp.total_bytes == ps.total_bytes
    for mine, theirs in zip(tp.buckets, ps.buckets):
        assert mine.lt_pad == theirs.lt_pad
        assert np.array_equal(mine.entry_idx, theirs.entry_idx)
        assert np.array_equal(mine.panel_T, theirs.panel_T)
    piece = tp.splits[0][0]
    kept = tp.device_panel(piece, keep=True)
    assert kept.dtype == torch.int8
    assert np.array_equal(kept.numpy(), ps.buckets[piece.bucket].panel_T)
    assert tp.device_panel(piece, keep=True) is kept
    assert tp.device_panel(tp.splits[0][-1], keep=False) is not \
        tp.device_panel(tp.splits[0][-1], keep=False)


def test_resident_panels_own_the_residues(dbs):
    """One TorchPanelSet per target DB and device: the prefilter's panels
    and the SW stage's residues come from the same object, the residues are
    uploaded once, and asking for residues alone builds no panel."""
    tdb = dbs[1].tdb
    panels = resident_panels(tdb, CPU)
    assert resident_panels(tdb, CPU) is panels
    assert tung.resident_prefilter(tdb, CPU).panels is panels
    fresh = TorchPanelSet(tdb, CPU)
    res_aa, res_ss = fresh.residues()
    assert fresh._buckets is None and fresh.residues()[0] is res_aa
    assert res_aa.dtype == res_ss.dtype == torch.int8
    assert np.array_equal(res_aa.numpy(), np.asarray(tdb.aa))
    assert np.array_equal(res_ss.numpy(), np.asarray(tdb.ss))
    assert np.array_equal(fresh.offsets, np.asarray(tdb.offsets))


@pytest.mark.parametrize("prefilter_mode", [1, 2])
def test_search_m8_matches_jax(dbs, prefilter_mode):
    """`search` + m8 formatting with the --gpu 1 parameters (mode 1) and
    with the exhaustive prefilter (mode 2): byte-identical lines (about 1600
    hits, backtraces on)."""
    jax_side, port_side = dbs
    kw = dict(GPU_KW, prefilter_mode=prefilter_mode)
    want_res = jpipe.search(jax_side.qdb, jax_side.tdb,
                            jparams.SearchParams(**kw), same_db=False)
    got_res = tpipe.search(port_side.qdb, port_side.tdb, SearchParams(**kw),
                           CPU, same_db=False)
    want = jconv.format_results(jax_side.qdb, jax_side.tdb, want_res, M8,
                                with_backtrace=True)
    got = format_results(port_side.qdb, port_side.tdb, got_res, M8,
                         with_backtrace=True)
    assert len(want) > 1000
    assert got == want


@pytest.fixture(scope="module")
def mode3_dbs(dbs, tmp_path_factory):
    """120 targets and 3 queries, one of them target 5 under its own key."""
    from foldseek_tpu_torch.db.storage import StructDBWriter
    d = tmp_path_factory.mktemp("torch_mode3")
    port = dbs[1]

    def write(path, entries):
        w = StructDBWriter(str(path))
        for key, db, i in entries:
            w.add_entry(key, db.names[i], db.headers[i], db.get_aa(i),
                        db.get_ss(i), db.get_ca(i))
        w.finish()
    write(d / "t120", [(i, port.tdb, i) for i in range(120)])
    write(d / "q3", [(5, port.tdb, 5), (200, port.qdb, 0), (201, port.qdb, 1)])
    dirs = (str(d / "t120"), str(d / "q3"))
    return Side(jstorage.load_db, *dirs), Side(tdbmod.load_db, *dirs)


@pytest.mark.parametrize("same_db", [False, True])
def test_mode3_m8_matches_jax(mode3_dbs, same_db):
    """--prefilter-mode 3: the port's records and m8 bytes equal
    foldseek_tpu's (its Pallas SW kernel in interpret mode). With same_db
    the query that is also a target keeps its identity hit whatever its
    E-value, and no surviving hit has score 0 (where the two packages'
    q_end conventions would differ)."""
    jax_side, port_side = mode3_dbs
    kw = dict(prefilter_mode=3, max_seqs=50)
    want_res = jpipe.search(jax_side.qdb, jax_side.tdb,
                            jparams.SearchParams(**kw), same_db=same_db)
    got_res = tpipe.search(port_side.qdb, port_side.tdb, SearchParams(**kw),
                           CPU, same_db=same_db)
    assert list(got_res) == list(want_res) == [5, 200, 201]
    for qkey, want in want_res.items():
        got = got_res[qkey]
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert all(r.score > 0 and r.backtrace == "" and r.q_start == 0
                   for r in got)
    assert got_res[5][0].db_key == 5
    assert sum(len(v) for v in got_res.values()) > 60
    want = jconv.format_results(jax_side.qdb, jax_side.tdb, want_res, M8)
    assert format_results(port_side.qdb, port_side.tdb, got_res, M8) == want


def test_mode3_gates_and_cut(mode3_dbs):
    """A strict E-value drops everything but the same-DB identity hit; the
    list is cut at max_seqs after sorting by (evalue, -score, t_len, key)."""
    from foldseek_tpu_torch.search.results import compare_hits
    port = mode3_dbs[1]
    strict = tpipe.search(port.qdb, port.tdb,
                          SearchParams(prefilter_mode=3, evalue_thr=0.0), CPU,
                          same_db=True)
    assert [r.db_key for r in strict[5]] == [5]
    assert strict[200] == [] and strict[201] == []
    full = tpipe.search(port.qdb, port.tdb, SearchParams(prefilter_mode=3),
                        CPU, same_db=False)
    cut = tpipe.search(port.qdb, port.tdb,
                       SearchParams(prefilter_mode=3, max_seqs=7), CPU,
                       same_db=False)
    for qkey, hits in full.items():
        assert len(hits) > 7
        assert hits == sorted(hits, key=compare_hits)
        assert cut[qkey] == hits[:7]


def test_mode3_splits_queries_under_budget(mode3_dbs, monkeypatch):
    """When the pairs' plan and results exceed the device budget the queries
    go through the SW launch point in groups; the records do not change."""
    port = mode3_dbs[1]
    params = SearchParams(prefilter_mode=3, max_seqs=30)
    want = tpipe.search(port.qdb, port.tdb, params, CPU, same_db=True)
    calls = []
    real = tung.sw_scores_pairs
    monkeypatch.setattr(tung, "sw_scores_pairs",
                        lambda *a, **k: calls.append(len(a[2]) - 1) or real(*a, **k))
    monkeypatch.setattr(tung, "panel_budget",
                        lambda dev: 2 * tung.MODE3_BYTES_PER_PAIR * port.tdb.size)
    got = tpipe.search(port.qdb, port.tdb, params, CPU, same_db=True)
    assert calls == [2, 1]
    assert got == want and sum(len(v) for v in got.values()) > 60


def test_mode3_resumes_from_prefaln(mode3_dbs, tmp_path, monkeypatch):
    """With a tmp dir the mode-3 results persist under the stage name
    `prefaln`; a second run reads them back without scoring anything."""
    port = mode3_dbs[1]
    params = SearchParams(prefilter_mode=3, max_seqs=20)
    first = tpipe.search(port.qdb, port.tdb, params, CPU, same_db=False,
                         tmp_dir=str(tmp_path))
    assert list(tmp_path.rglob("prefaln*"))
    monkeypatch.setattr(tung, "ungapped_and_gapped_results",
                        lambda *a, **k: pytest.fail("stage ran again"))
    again = tpipe.search(port.qdb, port.tdb, params, CPU, same_db=False,
                         tmp_dir=str(tmp_path))
    assert format_results(port.qdb, port.tdb, again, M8) == \
        format_results(port.qdb, port.tdb, first, M8)


def test_create_db_writes_identical_files(golden_dir, tmp_path):
    """The re-homed ingest path (PDB parser, Foldcomp reader, backbone
    rebuild, 3Di encoder, DB writer) writes byte-identical DB files."""
    from foldseek_tpu_torch.db import create_db as port_create_db
    from foldseek_tpu_torch.db import synth_db as port_synth_db
    inputs = _fixture_inputs(golden_dir)
    jbase = create_db(inputs, str(tmp_path / "jax"))
    pbase = port_create_db(inputs, str(tmp_path / "port"))
    synth_db(jbase, 50, str(tmp_path / "jax_syn"), seed=3)
    port_synth_db(pbase, 50, str(tmp_path / "port_syn"), seed=3)
    for a, b in (("jax", "port"), ("jax_syn", "port_syn")):
        names = sorted(os.listdir(tmp_path / a))
        assert names == sorted(os.listdir(tmp_path / b)) and len(names) >= 8
        for name in names:
            assert (tmp_path / a / name).read_bytes() == \
                (tmp_path / b / name).read_bytes(), name


@pytest.mark.parametrize("columns", [
    M8, "query,target,qlen,tlen,alnlen,qcov,tcov,cigar,qaln,taln,alntmscore,"
        "lddt,prob,qseq,tseq,qheader,theader,raw,pident,nident"])
def test_format_results_identical_lines(dbs, tmp_path, columns):
    """One result DB, written by the port, read back and formatted by each
    package's own code: identical lines (default m8 and structure columns)."""
    from foldseek_tpu.search.resultdb import read_result_db as jread
    from foldseek_tpu_torch.search.resultdb import (read_result_db,
                                                    write_result_db)
    jax_side, port_side = dbs
    res = tpipe.search(port_side.qdb, port_side.tdb,
                       SearchParams(**GPU_KW, max_seqs=40), CPU, same_db=False)
    write_result_db(res, str(tmp_path / "res"), add_backtrace=True)
    want = jconv.format_results(jax_side.qdb, jax_side.tdb,
                                jread(str(tmp_path / "res"))[0], columns,
                                with_backtrace=True)
    got = format_results(port_side.qdb, port_side.tdb,
                         read_result_db(str(tmp_path / "res"))[0], columns,
                         with_backtrace=True)
    assert len(want) > 100 and got == want


def test_native_binding_agrees(dbs):
    """The port's binding builds the shared C++ sources into its own build
    directory and agrees with foldseek_tpu's binding on the entry points the
    search path uses: block-aligner backtraces, LDDT degrees, batched
    TM/LDDT gates."""
    from foldseek_tpu import native as jnative
    from foldseek_tpu_torch import native as tnative
    from foldseek_tpu_torch.ops.sw import QueryProfile, sw_score_endpos_np
    from foldseek_tpu_torch.search.align import _block_mats
    assert tnative.get_lib() is not None and jnative.get_lib() is not None
    assert os.path.dirname(tnative._SO).endswith(
        os.path.join("foldseek_tpu_torch", "build"))
    port = dbs[1]
    tdb, qdb = port.tdb, port.qdb
    prof = QueryProfile(np.asarray(qdb.get_aa(0)), np.asarray(qdb.get_ss(0)))
    tids = np.arange(0, 40)
    ends = np.array([sw_score_endpos_np(prof.prof_aa, prof.prof_ss,
                                        np.asarray(tdb.get_aa(t)),
                                        np.asarray(tdb.get_ss(t)))
                     for t in tids])
    ok = ends[:, 0] > 40
    assert ok.sum() >= 5
    fprof = prof.flipped()
    args = (fprof.q_aa, fprof.q_ss,
            fprof.bias_aa.astype(np.int16) + fprof.bias_ss.astype(np.int16),
            *_block_mats(prof), np.asarray(tdb.aa), np.asarray(tdb.ss),
            np.asarray(tdb.offsets)[tids[ok]], ends[ok, 2].astype(np.int32),
            ends[ok, 0].astype(np.int32), ends[ok, 1].astype(np.int32), 10, 1)
    got, want = tnative.batch_recover_block(*args), \
        jnative.batch_recover_block(*args)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert list(got[3]) == list(want[3]) and any(b for b in got[3])
    q_ca = np.asarray(qdb.get_ca(0))
    deg = tnative.lddt_degree(q_ca)
    assert np.array_equal(deg, jnative.lddt_degree(q_ca))
    keep = [j for j, b in enumerate(got[3]) if b and b != "BLOCK_FAIL"]
    gate_args = (q_ca, deg, [np.asarray(tdb.get_ca(tids[ok][j])) for j in keep],
                 [int(got[0][j]) for j in keep], [int(got[1][j]) for j in keep],
                 [got[3][j] for j in keep], [len(q_ca)] * len(keep), True, True)
    g, w = tnative.batch_gates(*gate_args), jnative.batch_gates(*gate_args)
    assert sorted(g) == sorted(w) and {"tm", "lddt"} <= set(g)
    for k in g:
        assert np.array_equal(np.asarray(g[k]), np.asarray(w[k]))


def _run_port_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "foldseek_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_easy_search_cli_matches_jax(golden_dir, tmp_path):
    """`python -m foldseek_tpu_torch easy-search ... --gpu 1` in a
    subprocess writes the m8 that foldseek_tpu's easy_search writes."""
    inputs = _fixture_inputs(golden_dir)
    tdir = tmp_path / "targets"
    tdir.mkdir()
    for f in inputs:
        shutil.copy(f, tdir)
    query = inputs[0]
    proc = _run_port_cli(["easy-search", query, str(tdir), str(tmp_path / "port.m8"),
                          str(tmp_path / "tmp_port"), "--gpu", "1", "--device",
                          "cpu", "-v", "1"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    want = jpipe.easy_search(query, str(tdir), str(tmp_path / "jax.m8"),
                             str(tmp_path / "tmp_jax"),
                             jparams.SearchParams(prefilter_mode=1))
    got = (tmp_path / "port.m8").read_text()
    assert want and got == (tmp_path / "jax.m8").read_text()


def test_easy_search_cli_mode3_matches_jax(golden_dir, tmp_path):
    """`python -m foldseek_tpu_torch easy-search ... --prefilter-mode 3`
    writes the m8 that foldseek_tpu's easy_search writes in that mode."""
    inputs = _fixture_inputs(golden_dir)
    tdir = tmp_path / "targets"
    tdir.mkdir()
    for f in inputs:
        shutil.copy(f, tdir)
    proc = _run_port_cli(["easy-search", inputs[1], str(tdir),
                          str(tmp_path / "port.m8"), str(tmp_path / "tmp_port"),
                          "--prefilter-mode", "3", "--device", "cpu", "-v", "1"],
                         cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    want = jpipe.easy_search(inputs[1], str(tdir), str(tmp_path / "jax.m8"),
                             str(tmp_path / "tmp_jax"),
                             jparams.SearchParams(prefilter_mode=3))
    got = (tmp_path / "port.m8").read_text()
    assert len(want) > 5 and got == (tmp_path / "jax.m8").read_text()


def test_easy_search_profile_dir_writes_trace(golden_dir, tmp_path,
                                              monkeypatch):
    """`easy-search --profile-dir D` writes a torch.profiler Chrome trace
    into D and the m8 of the same run without the flag."""
    from foldseek_tpu_torch.cli import main as tmain
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    inputs = _fixture_inputs(golden_dir)
    m8 = []
    for name, extra in (("plain", []),
                        ("traced", ["--profile-dir", str(tmp_path / "prof")])):
        out = tmp_path / f"{name}.m8"
        assert tmain(["easy-search", inputs[0], inputs[1], str(out),
                      str(tmp_path / f"tmp_{name}"), "--gpu", "1",
                      "--device", "cpu", "-v", "1", *extra]) == 0
        m8.append(out.read_text())
    assert m8[0] and m8[0] == m8[1]
    trace = tmp_path / "prof" / "easy_search_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_search_cli_writes_result_db(dbs, tmp_path):
    tdb, qdb = dbs[1].tdb, dbs[1].qdb
    proc = _run_port_cli(["search", qdb.path, tdb.path, str(tmp_path / "res"),
                          str(tmp_path / "tmp"), "--gpu", "1", "--device", "cpu",
                          "-a", "-v", "1"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    from foldseek_tpu.search.resultdb import read_result_db
    results, has_bt = read_result_db(str(tmp_path / "res"))
    assert has_bt and sum(len(v) for v in results.values()) > 1000


def test_cli_refuses_missing_cuda_and_unknown_verbs(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_port_cli(["easy-search", "q", "t", "o", "tmp", "--gpu", "1"],
                         cwd=str(tmp_path))
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert _run_port_cli(["databases", "x", "y"], cwd=str(tmp_path)).returncode == 1


def _imported_roots(path):
    """Top-level names of every import statement in a file, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "foldseek_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_sources_import_neither_package():
    """No file of the port (parallel/ included), and not chip_smoke.py,
    holds an import of foldseek_tpu or jax, at top level or inside a
    function."""
    files = _port_sources()
    assert len(files) > 40
    parallel = os.path.join(REPO, "foldseek_tpu_torch", "parallel")
    assert {os.path.join(parallel, f"{m}.py")
            for m in ("distributed", "mesh", "worker")} <= set(files)
    for path in files:
        assert not {"foldseek_tpu", "jax", "jaxlib"} & _imported_roots(path), path


def test_port_never_imports_jax(golden_dir, tmp_path):
    """Importing every module of the port (parallel/ included), then through
    its CLI on the CPU an easy-search, createdb, createindex, an indexserver
    round trip (a served search) and convertalis, and a distributed search
    in a world of one rank, leaves neither jax nor any foldseek_tpu module
    in sys.modules."""
    inputs = _fixture_inputs(golden_dir)
    sock_dir = tempfile.mkdtemp(prefix="fs")
    if len(sock_dir) > 90:
        shutil.rmtree(sock_dir)
        sock_dir = tempfile.mkdtemp(prefix="fs", dir="/tmp")
    db, sock = str(tmp_path / "db"), os.path.join(sock_dir, "s.sock")
    cpu = "'--device', 'cpu', '-v', '1'"
    code = ("import importlib, os, pkgutil, sys, threading, time\n"
            "import foldseek_tpu_torch as p\n"
            "from foldseek_tpu_torch.cli import main\n"
            "from foldseek_tpu_torch.server import IndexServerClient\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'foldseek_tpu_torch.')"
            " if not m.name.endswith('__main__')]\n"
            "for n in names: importlib.import_module(n)\n"
            f"rc = [main(['easy-search', {inputs[0]!r}, {inputs[1]!r}, "
            f"{str(tmp_path / 'o.m8')!r}, {str(tmp_path / 'tmp')!r}, "
            f"'--gpu', '1', {cpu}])]\n"
            f"rc.append(main(['createdb', *{inputs!r}, {db!r}, '-v', '1']))\n"
            f"rc.append(main(['createindex', {db!r}, '-v', '1']))\n"
            "t = threading.Thread(target=main, args=(['indexserver', "
            f"{db!r}, {sock!r}, {cpu}],))\n"
            "t.start()\n"
            f"while not os.path.exists({sock!r}): time.sleep(0.1)\n"
            f"rc.append(main(['search', {db!r}, {db!r}, {db + '_res'!r}, "
            f"{str(tmp_path / 'tmp2')!r}, '--index-server', {sock!r}, {cpu}]))\n"
            f"c = IndexServerClient({sock!r}); c.shutdown(); c.close(); t.join()\n"
            f"rc.append(main(['convertalis', {db!r}, {db!r}, {db + '_res'!r}, "
            f"{str(tmp_path / 'res.m8')!r}, '-v', '1']))\n"
            "from foldseek_tpu_torch.db import load_db\n"
            "from foldseek_tpu_torch.parallel.distributed import "
            "distributed_search\n"
            "from foldseek_tpu_torch.search import SearchParams\n"
            f"d = load_db({db!r})\n"
            "res = distributed_search(d, d, SearchParams(prefilter_mode=1), "
            "'cpu')\n"
            "rc.append(int(not all(res.values())))\n"
            "bad = sorted(k for k in sys.modules if k in ('jax', 'foldseek_tpu')"
            " or k.startswith(('jax.', 'foldseek_tpu.')))\n"
            "print(len(names), sum(rc), bad)\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=REPO,
                                       FOLDSEEK_TPU_FORK="0"))
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr
    n, rc, bad = proc.stdout.strip().split(" ", 2)
    assert int(n) >= 38 and rc == "0" and bad == "[]"
    assert (tmp_path / "o.m8").read_text().count("\n") >= 1
    assert (tmp_path / "res.m8").read_text().count("\n") >= 17


def test_commands_match_jax():
    """The port registers every verb of foldseek_tpu's command line and no
    other."""
    from foldseek_tpu.cli import COMMANDS as jax_commands
    from foldseek_tpu_torch.cli import COMMANDS
    assert sorted(COMMANDS) == sorted(jax_commands) and len(COMMANDS) == 96


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port, torch, numpy and the standard
    library, never jax or foldseek_tpu itself."""
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "foldseek_tpu_torch" in roots
    assert roots <= {"foldseek_tpu_torch", "torch", "numpy", "__future__",
                     *sys.stdlib_module_names}, roots


def test_only_chip_smoke_reaches_the_v1_kernels():
    """The kernels of the version before the Hopper redesign (csrc/*_v1.cu)
    are gone with the timing turns that kept them: csrc/ holds the two
    kernel sources and their shared header, and no source of the port, nor
    chip_smoke.py, names a `_v1` kernel."""
    csrc = os.path.join(REPO, "foldseek_tpu_torch", "csrc")
    assert sorted(os.listdir(csrc)) == ["dp_common.cuh", "gapless.cu", "sw.cu"]
    for path in _port_sources():
        with open(path) as f:
            assert "_v1" not in f.read(), path


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited header in csrc/ changes the name of the library a kernel
    builds into, so a stale library is never loaded."""
    from foldseek_tpu_torch.ops import _build
    shutil.copytree(_build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path / "csrc"))
    before = _build.library_path("sw")
    with open(tmp_path / "csrc" / "dp_common.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("sw") != before
    assert _build.library_path("sw").startswith(_build.BUILD_DIR)


def test_get_device():
    assert get_device("cpu") == CPU
    if torch.cuda.is_available():
        assert get_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_device("cuda")
    with pytest.raises(RuntimeError):
        get_device("meta")


@pytest.mark.parametrize("change", [
    dict(prefilter_mode=0), dict(cluster_search=1),
    dict(num_iterations=2), dict(alignment_type=1), dict(alignment_type=3),
    dict(index_server="index.sock"), "device_gates"])
def test_unported_modes_raise(dbs, change, monkeypatch, tmp_path):
    """The modes once refused as not ported run and return hits: the k-mer
    prefilter, --cluster-search over a createclusearchdb triple, iterative
    search, alignment types 1 and 3, the device gates, and --index-server
    (a round trip through the target DB served on the CPU, whose records
    equal the in-process search's)."""
    tdb, qdb = dbs[1].tdb, dbs[1].qdb
    params = replace(SearchParams(**GPU_KW), max_seqs=20)
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")   # a JAX client lives here
    if change == "device_gates":
        monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "1")
    else:
        params = replace(params, **change)
    if change != "device_gates" and "index_server" in change:
        import threading
        import time

        from foldseek_tpu_torch import server as tserver
        sock_dir = tempfile.mkdtemp(prefix="fs")
        if len(sock_dir) > 90:
            shutil.rmtree(sock_dir)
            sock_dir = tempfile.mkdtemp(prefix="fs", dir="/tmp")
        sock = os.path.join(sock_dir, "s.sock")
        thread = threading.Thread(target=tserver.serve,
                                  args=(tdb.path, sock, 1000, "cpu"),
                                  daemon=True)
        thread.start()
        try:
            while not os.path.exists(sock):
                time.sleep(0.1)
            res = tpipe.search(qdb, tdb, replace(params, index_server=sock),
                               CPU, same_db=False)
            client = tserver.IndexServerClient(sock)
            client.shutdown()
            client.close()
            thread.join(timeout=60)
        finally:
            shutil.rmtree(sock_dir, ignore_errors=True)
        local = tpipe.search(qdb, tdb, replace(params, index_server=""), CPU,
                             same_db=False)
        lines = format_results(qdb, tdb, res, M8, with_backtrace=True)
        assert lines == format_results(qdb, tdb, local, M8,
                                       with_backtrace=True)
        assert len(lines) >= qdb.size
        return
    if change != "device_gates" and "cluster_search" in change:
        from foldseek_tpu_torch.search.clusearch import create_clusearch_db
        keys = [int(k) for k in tdb.keys]
        tdb = create_clusearch_db(
            tdb, {keys[i]: keys[i:i + 4] for i in range(0, len(keys), 4)},
            str(tmp_path / "clu"))
    if change != "device_gates" and "num_iterations" in change:
        res = tpipe.iterative_search(qdb, tdb, params, 2, CPU, same_db=False)
    else:
        res = tpipe.search(qdb, tdb, params, CPU, same_db=False)
    assert sum(len(v) for v in res.values()) >= qdb.size


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line without a
    card, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

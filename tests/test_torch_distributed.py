"""The port's distribution (`foldseek_tpu_torch/parallel`) on the CPU: a
2-rank gloo world spawned with the port's own worker module
(`python -m foldseek_tpu_torch.parallel.worker`, a `file://` rendezvous in
the test's tmp dir, every rank under a 120 s limit and its peers killed when
one fails) against foldseek_tpu and against the port's single process, all
exact:
  * the sharded prefilter's candidate lists against JAX's
    `DistributedPrefilter` on conftest's 8-device CPU mesh and against both
    packages' `UngappedPrefilter` at -c 0, also on a DB whose keys do not
    ascend with its rows and whose 20 tied best hits straddle the rank
    boundary with max_seqs below each rank's row count;
  * `sharded_gapless_long` of one long query;
  * `distributed_search`'s m8 bytes, `cluster_db`'s clusters and
    `multimer_search`'s score lines against JAX's single-process `search`,
    `cluster_db` and `multimer_search`;
  * `host_row_range` against JAX's for world sizes 1, 2, 3 and 8;
  * `init_distributed` without a world returns 0, and a world that cannot
    form raises instead of running one rank alone.

The DBs grow from the repo's fixture structures with the port's
db/synth.py; the two packages meet only through those directories."""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from foldseek_tpu.cluster import workflow as jcluster
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.multimer import workflow as jmultimer
from foldseek_tpu.parallel import distributed as jdist
from foldseek_tpu.search import convertalis as jconvertalis
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import pipeline as jpipeline
from foldseek_tpu.search import ungapped as jungapped
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch.db.storage import StructDBWriter
from foldseek_tpu_torch.parallel import distributed as tdist
from foldseek_tpu_torch.search import SearchParams
from foldseek_tpu_torch.search import align as talign
from foldseek_tpu_torch.search.results import result_to_line
from foldseek_tpu_torch.search import ungapped as tungapped

REPO = pathlib.Path(__file__).parents[1]
CPU = torch.device("cpu")
MAX_SEQS = 16
RANK_TIMEOUT = 120
# rows of the tie DB that are one structure, rows 118-137: the 2-rank
# boundary (row 128) cuts them 10 / 10
TIE_ROWS = range(118, 138)


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tie_db(src, query, path: str):
    """`src` with rows TIE_ROWS replaced by copies of `query`'s entry 0 and
    every key permuted: the keys do not ascend with the rows."""
    keys = np.random.default_rng(3).permutation(src.size)
    w = StructDBWriter(path)
    for i in range(src.size):
        db, j = (query, 0) if i in TIE_ROWS else (src, i)
        w.add_entry(int(keys[i]), f"e{i}", f"e{i}", np.asarray(db.get_aa(j)),
                    np.asarray(db.get_ss(j)), np.asarray(db.get_ca(j)),
                    db.mask[db.offsets[j]:db.offsets[j + 1]])
    return w.finish()


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed")
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    base = tdbmod.create_db(inputs, str(d / "base"))
    paths = {}
    for name, n, seed in (("t200", 200, 1), ("q6", 6, 4), ("c40", 40, 2),
                          ("m40", 40, 3), ("mq6", 6, 5)):
        tdbmod.synth_db(base, n, str(d / name), seed=seed)
        paths[name] = str(d / name)
    for name in ("m40", "mq6"):
        n = tdbmod.load_db(paths[name]).size
        np.save(os.path.join(paths[name], "fileids.npy"),
                (np.arange(n) // 2).astype(np.uint32))
    paths["tie"] = str(d / "tie")
    _tie_db(tdbmod.load_db(paths["t200"]), tdbmod.load_db(paths["q6"]),
            paths["tie"])
    paths["dir"] = d
    return paths


def spawn_world(out: str, size: int, args, store: str):
    """`size` ranks of the port's worker on the CPU with gloo, meeting in the
    file store `store`; each rank's JSON output, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", FOLDSEEK_TPU_FORK="0",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "foldseek_tpu_torch.parallel.worker", out,
         *args, "--init-method", f"file://{store}", "--world-size",
         str(size), "--rank", str(r), "--device", "cpu", "--timeout",
         str(RANK_TIMEOUT)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(size)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(size):
        with open(f"{out}.{r}.json") as f:
            outs.append(json.load(f))
    return outs


@pytest.fixture(scope="module")
def ranks(dbs):
    """One 2-rank world over every path of the worker."""
    outs = spawn_world(
        str(dbs["dir"] / "out"), 2,
        ["--queries", dbs["q6"], "--targets", dbs["t200"], dbs["tie"],
         "--cluster-db", dbs["c40"], "--multimer", dbs["mq6"], dbs["m40"],
         "--max-seqs", str(MAX_SEQS)], str(dbs["dir"] / "store"))
    assert [(o["rank"], o["size"]) for o in outs] == [(0, 2), (1, 2)]
    return outs


def _result(ranks, path):
    """The path's result, which every rank must hold alike."""
    got = [o["paths"][path]["result"] for o in ranks]
    assert all(g == got[0] for g in got)
    return got[0]


def _seqs(db):
    return [np.asarray(db.get_ss(i)) for i in range(db.size)]


def _as_lists(hits):
    return [[list(h) for h in q] for q in hits]


@pytest.mark.parametrize("target", [0, 1], ids=["t200", "ties"])
def test_prefilter_two_ranks_match_single_process(dbs, ranks, target):
    """Both ranks' lists equal the port's and JAX's `UngappedPrefilter` at
    -c 0. On the tie DB the 20 equal best hits of query 0 straddle the rank
    boundary, max_seqs (16) is below each rank's rows, and the 16 kept tie
    and come from both ranks."""
    path = dbs["t200"] if target == 0 else dbs["tie"]
    seqs = _seqs(tdbmod.load_db(dbs["q6"]))
    port = tungapped.UngappedPrefilter(tdbmod.load_db(path), CPU).query_batch(
        seqs, SearchParams(max_seqs=MAX_SEQS))
    jax = jungapped.UngappedPrefilter(jstorage.load_db(path)).query_batch(
        seqs, jparams.SearchParams(max_seqs=MAX_SEQS))
    got = _result(ranks, f"prefilter_{target}")
    assert got == _as_lists(port) == _as_lists(jax)
    if target == 1:
        # query 0's kept hits all tie, and come from both ranks' rows
        row = {int(k): i for i, k in enumerate(tdbmod.load_db(path).keys)}
        rows = [row[k] for k, _ in got[0]]
        assert len({s for _, s in got[0]}) == 1
        assert min(rows) < 128 <= max(rows)


def test_prefilter_matches_jax_distributed(dbs, ranks):
    """JAX's DistributedPrefilter on the 8-device CPU mesh gives the lists
    of the port's two ranks."""
    jdb = jstorage.load_db(dbs["t200"])
    jax = jdist.DistributedPrefilter(jdb).query_batch(
        _seqs(jstorage.load_db(dbs["q6"])),
        jparams.SearchParams(max_seqs=MAX_SEQS))
    assert _result(ranks, "prefilter_0") == _as_lists(jax)


def test_long_query_matches_single_process(dbs, ranks):
    """sharded_gapless_long of the six queries joined (about 800 rows) is the
    single-process prefilter's list of that query."""
    joined = np.concatenate(_seqs(tdbmod.load_db(dbs["q6"])))
    want = tungapped.UngappedPrefilter(tdbmod.load_db(dbs["t200"]),
                                       CPU).query(
        joined, SearchParams(max_seqs=MAX_SEQS))
    assert _result(ranks, "long") == [list(h) for h in want]


def test_search_m8_matches_jax(dbs, ranks):
    """distributed_search (sharded prefilter, query-sharded align, the
    merge of record lines) prints the m8 of JAX's single-process search."""
    jq, jt = jstorage.load_db(dbs["q6"]), jstorage.load_db(dbs["t200"])
    params = jparams.SearchParams(prefilter_mode=1, add_backtrace=True,
                                  max_seqs=MAX_SEQS)
    res = jpipeline.search(jq, jt, params, same_db=False)
    lines = jconvertalis.format_results(jq, jt, res, params.format_output,
                                        with_backtrace=True)
    want = "".join(line + "\n" for line in lines)
    assert lines and _result(ranks, "search") == want


def test_cluster_two_ranks_matches_jax(dbs, ranks):
    """cluster_db with its align stages query-sharded over two ranks gives
    JAX's single-process clusters."""
    clusters = jcluster.cluster_db(jstorage.load_db(dbs["c40"]),
                                   jcluster.ClusterParams())
    want = [[int(k), [int(m) for m in v]] for k, v in sorted(clusters.items())]
    assert _result(ranks, "cluster") == want


def test_multimer_two_ranks_matches_jax(dbs, ranks):
    """multimer_search with the chain search's and the expand re-align's
    align stages over two ranks gives JAX's single-process score lines."""
    res = jmultimer.multimer_search(jstorage.load_db(dbs["mq6"]),
                                    jstorage.load_db(dbs["m40"]),
                                    jparams.SearchParams())
    want = [f"{qk}\t{line}" for qk in sorted(res) for line in res[qk]]
    assert want and _result(ranks, "multimer") == want


def test_world_of_one_in_process(dbs):
    """Without a process group every entry point is a world of one rank:
    the distributed prefilter is the single one, the sharded align stage is
    align_all, and alignment_backend gives align_all."""
    qdb, tdb = tdbmod.load_db(dbs["q6"]), tdbmod.load_db(dbs["t200"])
    params = SearchParams(max_seqs=MAX_SEQS)
    pref = tdist.DistributedPrefilter(tdb, device="cpu")
    assert (pref.st.row_start, pref.st.row_end) == (0, 256)
    hits = pref.query_batch(_seqs(qdb), params)
    assert hits == tungapped.UngappedPrefilter(tdb, CPU).query_batch(
        _seqs(qdb), params)
    cands = {int(qdb.keys[i]): [k for k, _ in h] for i, h in enumerate(hits)}
    got = tdist.sharded_align_all(qdb, tdb, cands, params, CPU)
    want = talign.align_all(qdb, tdb, cands, params, CPU)
    assert {k: [result_to_line(r, True) for r in v] for k, v in got.items()} \
        == {k: [result_to_line(r, True) for r in v] for k, v in want.items()}
    assert tdist.alignment_backend(talign.align_all) is talign.align_all


class _Device:
    """A device of a JAX mesh held by process `process_index`."""

    def __init__(self, process_index: int):
        self.process_index = process_index


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_host_row_range_matches_jax(size, monkeypatch):
    """Each rank's rows equal those JAX gives the process holding that
    device of a one-device-per-process mesh, for DBs of several sizes."""
    import jax
    devices = np.array([_Device(r) for r in range(size)])
    mesh = SimpleNamespace(devices=devices)
    for n in (1, 127, 128, 1000, 100_000):
        n_pad = tdist.padded_rows(n, size)
        assert n_pad % (size * tdist.ROW_MULTIPLE) == 0 and n_pad >= n
        for r in range(size):
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            assert tdist.host_row_range(n_pad, r, size) == \
                jdist.host_row_range(n_pad, mesh)


def test_init_distributed_without_world(monkeypatch):
    """No init_method and no MASTER_ADDR: nothing forms, 0 comes back and
    the world is one rank; WORLD_SIZE > 1 without an address raises."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.init_distributed(device="cpu") == 0
    assert tdist.world() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        tdist.init_distributed(device="cpu")


def test_world_that_cannot_form_raises(tmp_path):
    """Rank 0 of a 2-rank world whose peer never comes fails at its
    timeout: it does not go on alone."""
    code = ("from foldseek_tpu_torch.parallel.distributed import "
            "init_distributed\n"
            f"init_distributed('file://{tmp_path / 'store'}', 2, 0, "
            "device='cpu', timeout_seconds=2)\nprint('formed')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, timeout=RANK_TIMEOUT)
    assert p.returncode != 0 and b"formed" not in p.stdout

"""The port's resident index server (`server.py`, the `indexserver` /
`gpuserver` verbs) on the CPU: `ping`, `query` and `query_batch` against the
in-process prefilter and against foldseek_tpu's, foldseek_tpu's client
talking to the port's server (the protocol is the same bytes), `search
--index-server` against `search`, and `shutdown`.

The server runs in a daemon thread of the test process on the plain PyTorch
versions of the kernels. It serves one connection at a time, so each test
opens its own client and closes it. The two packages meet only through DB
directories, the socket and plain values. The socket lives in a short
directory: an AF_UNIX path holds at most 107 bytes."""
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from foldseek_tpu import server as jserver
from foldseek_tpu.db import storage as jstorage
from foldseek_tpu.db.synth import synth_db
from foldseek_tpu.ingest.createdb import create_db
from foldseek_tpu.search import params as jparams
from foldseek_tpu.search import ungapped as jung
from foldseek_tpu_torch import db as tdbmod
from foldseek_tpu_torch import server as tserver
from foldseek_tpu_torch.cli import main as tmain
from foldseek_tpu_torch.search import SearchParams
from foldseek_tpu_torch.search import ungapped as tung

CPU = torch.device("cpu")


def _fixture_inputs(golden_dir):
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


def _socket_dir():
    """A fresh directory whose socket path stays under the AF_UNIX limit."""
    d = tempfile.mkdtemp(prefix="fs")
    if len(d) > 90:
        shutil.rmtree(d)
        d = tempfile.mkdtemp(prefix="fs", dir="/tmp")
    return d


def _start(argv, sock):
    """Run the `indexserver` verb in a daemon thread; returns it once the
    socket answers a ping."""
    thread = threading.Thread(target=tmain, args=(argv,), daemon=True)
    thread.start()
    for _ in range(600):
        if os.path.exists(sock):
            try:
                client = tserver.IndexServerClient(sock)
            except OSError:
                pass
            else:
                assert client.ping()["ok"]
                client.close()
                return thread
        time.sleep(0.1)
    pytest.fail("index server did not come up")


class _client:
    """An `IndexServerClient` of one package inside a with: closed after."""

    def __init__(self, sock, module=tserver):
        self.client = module.IndexServerClient(sock)

    def __enter__(self):
        return self.client

    def __exit__(self, *exc):
        self.client.close()


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """200 targets and 4 queries grown from the fixture structures."""
    d = tmp_path_factory.mktemp("torch_server")
    base = create_db(_fixture_inputs(golden_dir), str(d / "base"))
    synth_db(base, 200, str(d / "t200"), seed=1)
    synth_db(base, 4, str(d / "q4"), seed=4)
    return str(d / "t200"), str(d / "q4")


@pytest.fixture(scope="module")
def served(dbs):
    """The target DB served on the CPU by `indexserver`; shut down at the
    end of the module."""
    sock_dir = _socket_dir()
    sock = os.path.join(sock_dir, "idx.sock")
    thread = _start(["indexserver", dbs[0], sock, "--device", "cpu", "-v",
                     "1"], sock)
    yield sock
    with _client(sock) as client:
        client.shutdown()
    thread.join(timeout=60)
    shutil.rmtree(sock_dir, ignore_errors=True)


def _queries(path):
    qdb = tdbmod.load_db(path)
    return [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]


def test_ping_and_query_match_in_process(dbs, served):
    """`ping` counts the targets; `query` of each query equals the port's
    in-process `UngappedPrefilter.query`."""
    tdb = tdbmod.load_db(dbs[0])
    pref = tung.UngappedPrefilter(tdb, CPU)
    with _client(served) as client:
        assert client.ping() == {"ok": True, "n_targets": tdb.size}
        for q in _queries(dbs[1]):
            hits = client.query(q)
            assert hits == pref.query(q, SearchParams()) and len(hits) > 3
        assert client.query(_queries(dbs[1])[0], max_seqs=5) == \
            pref.query(_queries(dbs[1])[0], SearchParams(max_seqs=5))


def test_query_batch_matches_in_process_and_jax(dbs, served):
    """`query_batch` equals the in-process batch and foldseek_tpu's
    in-process `UngappedPrefilter.query_batch`, as plain lists."""
    seqs = _queries(dbs[1]) + [np.asarray(tdbmod.load_db(dbs[0]).get_ss(7))]
    with _client(served) as client:
        got = client.query_batch(seqs)
    port = tung.UngappedPrefilter(tdbmod.load_db(dbs[0]), CPU).query_batch(
        seqs, SearchParams())
    jax = jung.UngappedPrefilter(jstorage.load_db(dbs[0])).query_batch(
        seqs, jparams.SearchParams())
    assert got == port == [[(int(k), int(s)) for k, s in h] for h in jax]
    # a target queried against its DB finds itself at the top score
    assert (7, got[-1][0][1]) in got[-1]


def test_jax_client_talks_to_port_server(dbs, served):
    """foldseek_tpu's `IndexServerClient` gets the same answers from the
    port's server: the protocol is kept byte for byte."""
    seqs = _queries(dbs[1])
    with _client(served) as client:
        want = (client.ping(), client.query_batch(seqs, 50),
                client.query(seqs[2]))
    with _client(served, jserver) as jclient:
        got = (jclient.ping(), jclient.query_batch(seqs, 50),
               jclient.query(seqs[2]))
    assert got == want and want[0]["n_targets"] == 200


def test_search_with_index_server_matches_without(dbs, served, tmp_path,
                                                  monkeypatch):
    """`search --gpu 1 --index-server` writes the result DB of `search
    --gpu 1`, and `server_prefilter` the candidate lists of the in-process
    ungapped prefilter."""
    sock = served
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    outs = []
    for name, extra in (("local", []), ("served", ["--index-server", sock])):
        res = str(tmp_path / name)
        assert tmain(["search", dbs[1], dbs[0], res, str(tmp_path / "tmp"),
                      "--gpu", "1", "-a", "--device", "cpu", "-v", "1",
                      *extra]) == 0
        m8 = str(tmp_path / f"{name}.m8")
        assert tmain(["convertalis", dbs[1], dbs[0], res, m8, "-v", "1"]) == 0
        with open(m8, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 20
    qdb, tdb = tdbmod.load_db(dbs[1]), tdbmod.load_db(dbs[0])
    assert tserver.server_prefilter(qdb, sock, 1000) == \
        tung.ungapped_prefilter(qdb, tdb, SearchParams(), CPU)


def test_shutdown_removes_socket(dbs):
    """`shutdown` answers, ends the server and removes its socket; the
    `gpuserver` alias serves the same way."""
    sock_dir = _socket_dir()
    sock = os.path.join(sock_dir, "g.sock")
    try:
        thread = _start(["gpuserver", dbs[0], sock, "--device", "cpu", "-v",
                         "1"], sock)
        with _client(sock) as client:
            assert client.query(_queries(dbs[1])[0], max_seqs=3)
            assert client.shutdown() is None
        thread.join(timeout=60)
        assert not thread.is_alive() and not os.path.exists(sock)
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)

"""The port's ingest from the network: the `databases` verb (db/databases.py)
against a local mirror and `createdb gs://...` (ingest/gcs.py) against a
local mock of the GCS JSON API, each against foldseek_tpu's on the same
payloads. Both servers listen on localhost only."""
import hashlib
import http.server
import io
import json
import os
import tarfile
import threading
import urllib.parse

import pytest

from foldseek_tpu import cli as jcli
from foldseek_tpu.ingest.createdb import create_db as jcreate_db
from foldseek_tpu_torch import cli as tcli
from foldseek_tpu_torch.db import databases as tdatabases
from foldseek_tpu_torch.ingest import createdb as tcreatedb
from foldseek_tpu_torch.ingest import gcs as tgcs

QUIET = ["-v", "1"]
FIXTURE = ("ref_supd1asha__d1itha_.pdb", "ref_supd1mbaa__d1or4a_.pdb",
           "ref_supd1itha__d1asha_.pdb")


def _files(golden_dir):
    return {n: (golden_dir / "msa" / "sup" / n).read_bytes() for n in FIXTURE}


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


class _Mirror:
    """A static HTTP server on localhost: path -> body."""

    def __init__(self, files):
        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = files.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass
        self.httpd = http.server.HTTPServer(("localhost", 0), H)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://localhost:{self.httpd.server_port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture()
def mirror(golden_dir, monkeypatch):
    """A mirror serving a tar.gz of fixture PDBs with its md5, a bad-md5
    copy and a GGUF payload; FOLDSEEK_TPU_DB_MIRROR points at it."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, body in _files(golden_dir).items():
            info = tarfile.TarInfo(name)
            info.size = len(body)
            tar.addfile(info, io.BytesIO(body))
    blob = buf.getvalue()
    srv = _Mirror({"/cath50": blob,
                   "/cath50.md5": hashlib.md5(blob).hexdigest().encode(),
                   "/bfvd": blob, "/bfvd.md5": b"deadbeef bad",
                   "/prostt5/model.gguf": b"GGUF" + b"\0" * 64})
    monkeypatch.setenv("FOLDSEEK_TPU_DB_MIRROR", srv.url)
    yield srv
    srv.stop()


def test_databases_catalog_matches_jax(capsys):
    assert tcli.DATABASES == jcli.DATABASES
    assert tcli.main(["databases"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in jcli.DATABASES)
    assert tcli.main(["databases", "NoSuchDB", "out"]) == 1


def test_databases_builds_the_jax_db(mirror, tmp_path):
    """The structure archive, downloaded, checked and unpacked, gives the
    same DB files as foldseek_tpu's `databases`."""
    for side, main in (("jax", jcli.main), ("port", tcli.main)):
        assert main(["databases", "CATH50", str(tmp_path / side),
                     str(tmp_path / f"{side}_tmp"), *QUIET]) == 0
    names = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "manifest.json" in names and "ca.npy" in names
    from foldseek_tpu_torch.db import load_db
    assert load_db(str(tmp_path / "port")).size == len(FIXTURE)


def test_databases_md5_mismatch_refused(mirror, tmp_path):
    with pytest.raises(ValueError, match="md5 mismatch"):
        tdatabases.download_database("BFVD", "https://x.invalid/bfvd",
                                     str(tmp_path / "out"),
                                     str(tmp_path / "tmp"))
    assert not os.path.exists(tmp_path / "out")


def test_databases_places_gguf(mirror, tmp_path):
    """The ProstT5 entry delivers model weights, not a structure DB."""
    out = str(tmp_path / "weights.gguf")
    tdatabases.download_database(
        "ProstT5", "https://x.invalid/prostt5/model.gguf", out,
        str(tmp_path / "tmp"))
    with open(out, "rb") as f:
        assert f.read() == b"GGUF" + b"\0" * 64


class _MockGCS(http.server.BaseHTTPRequestHandler):
    """The GCS JSON API's object listing (paginated, PAGE names a page) and
    media download, over `objects`."""
    objects = {}
    PAGE = 2
    listings = []
    downloads = []

    def log_message(self, *a):
        pass

    def _send(self, code, body=b""):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        parts = parsed.path.split("/")
        q = urllib.parse.parse_qs(parsed.query)
        # /storage/v1/b/<bucket>/o  or  /storage/v1/b/<bucket>/o/<object>
        if len(parts) == 6 and parts[5] == "o":
            prefix = q.get("prefix", [""])[0]
            names = [n for n in sorted(self.objects) if n.startswith(prefix)]
            start = int(q.get("pageToken", ["0"])[0])
            page = {"items": [{"name": n}
                              for n in names[start:start + self.PAGE]]}
            if start + self.PAGE < len(names):
                page["nextPageToken"] = str(start + self.PAGE)
            type(self).listings.append((prefix, start))
            self._send(200, json.dumps(page).encode())
        elif len(parts) == 7 and parts[5] == "o":
            type(self).downloads.append(urllib.parse.unquote(parts[6]))
            data = self.objects.get(urllib.parse.unquote(parts[6]))
            self._send(404) if data is None else self._send(200, data)
        else:
            self._send(404)


@pytest.fixture()
def mock_gcs(golden_dir, monkeypatch, tmp_path):
    _MockGCS.objects = {f"afdb/{n}": b for n, b in _files(golden_dir).items()}
    _MockGCS.objects["other/readme.txt"] = b"not a structure"
    _MockGCS.listings = []
    _MockGCS.downloads = []
    srv = http.server.HTTPServer(("localhost", 0), _MockGCS)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv("FOLDSEEK_TPU_GCS_ENDPOINT",
                       f"http://localhost:{srv.server_port}")
    monkeypatch.setenv("FOLDSEEK_TPU_GCS_CACHE", str(tmp_path / "cache"))
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_createdb_from_gcs_matches_jax(mock_gcs, tmp_path):
    """createdb of a gs:// prefix, through the port's command line, writes
    the DB that foldseek_tpu's create_db writes from the same bucket."""
    jcreate_db(["gs://testbucket/afdb/"], str(tmp_path / "jax"))
    assert tcli.main(["createdb", "gs://testbucket/afdb/",
                      str(tmp_path / "port"), *QUIET]) == 0
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    from foldseek_tpu_torch.db import load_db
    assert load_db(str(tmp_path / "port")).size == len(FIXTURE)


def test_gcs_listing_prefix_and_pages(mock_gcs):
    """Three objects under afdb/ come back over two pages of two; the
    prefix keeps other/ out."""
    names = tgcs.list_objects("b", "afdb/")
    assert names == [f"afdb/{n}" for n in sorted(FIXTURE)]
    assert _MockGCS.listings == [("afdb/", 0), ("afdb/", 2)]
    assert tgcs.list_objects("b", "afdb/ref_supd1m") == [f"afdb/{FIXTURE[1]}"]


def test_gcs_include_filter_and_cache(mock_gcs, tmp_path):
    """--file-include filters object names before any download; a second
    walk reads the cache."""
    files = tcreatedb.collect_input_files(["gcs://b/afdb/"],
                                          file_include="d1mbaa")
    assert [os.path.basename(f) for f in files] == [FIXTURE[1]]
    assert _MockGCS.downloads == [f"afdb/{FIXTURE[1]}"]
    assert tcreatedb.collect_input_files(["gcs://b/afdb/"],
                                         file_include="d1mbaa") == files
    assert len(_MockGCS.downloads) == 1
    with pytest.raises(ValueError, match="escapes"):
        tgcs._safe_cache_dest(str(tmp_path), "b", "../../etc/passwd")

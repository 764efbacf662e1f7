"""Resident index server: the reference gpuserver's counterpart on a CUDA
card (reference: lib/mmseqs/src/util/gpuserver.cpp + GpuUtil.h shared-memory
handshake, ungappedprefilter.cpp:200-249 client side).

A long-lived process loads the target DB once, keeps its bucketed 3Di
panels resident on the device, and serves gapless-prefilter queries over a
unix socket, so that each search process skips the DB load, the panel build
and the upload.

Protocol (length-prefixed JSON + raw payload, the same bytes as
`foldseek_tpu/server.py`, so either package's client talks to either
server): a request is a `<II` header (JSON length, payload length), the JSON
and the payload. {"cmd": "query", "len": L, "max_seqs": N} followed by L
int8 bytes of the numeric 3Di query; response {"hits": [[key, score], ...]}.
"query_batch" sends many queries in one round trip ({"lens": [...]} +
concatenated int8 payload) and the server scans them as one query stack:
one gapless-kernel launch a panel piece. "ping" and "shutdown" round out the
surface. Only `max_seqs` crosses the wire: the client's coverage gate is not
applied server-side, as in `foldseek_tpu`.
"""
from __future__ import annotations

import json
import os
import socket
import struct
from typing import List, Tuple

import numpy as np

from .db.storage import load_db
from .device import get_device
from .utils.log import logger


def _send(conn, obj: dict, payload: bytes = b""):
    head = json.dumps(obj).encode()
    conn.sendall(struct.pack("<II", len(head), len(payload)) + head + payload)


def _recv(conn):
    hdr = b""
    while len(hdr) < 8:
        chunk = conn.recv(8 - len(hdr))
        if not chunk:
            return None, None
        hdr += chunk
    hlen, plen = struct.unpack("<II", hdr)
    buf = b""
    while len(buf) < hlen + plen:
        chunk = conn.recv(hlen + plen - len(buf))
        if not chunk:
            return None, None
        buf += chunk
    return json.loads(buf[:hlen]), buf[hlen:]


def serve(db_path: str, socket_path: str, max_seqs_default: int = 1000,
          device="cuda"):
    """Serve the DB at `db_path` on `socket_path` until a `shutdown`
    request. The prefilter is the server's own `UngappedPrefilter` on
    `device` (not the process's `resident_panels`, which another search in
    the same process would replace); the socket is removed on the way
    out. Raises when `device` is a CUDA device and none is available."""
    from .search.params import SearchParams
    from .search.ungapped import UngappedPrefilter
    db = load_db(db_path)
    pref = UngappedPrefilter(db, get_device(str(device)))
    # warm the kernel so the first client query is fast
    pref.query(np.asarray(db.get_ss(0)), SearchParams())
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(8)
    logger.info("index server: %d targets resident on %s, listening on %s",
                db.size, pref.device, socket_path)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                while True:
                    req, payload = _recv(conn)
                    if req is None:
                        break
                    if req["cmd"] == "ping":
                        _send(conn, {"ok": True, "n_targets": db.size})
                    elif req["cmd"] == "shutdown":
                        _send(conn, {"ok": True})
                        return
                    elif req["cmd"] == "query":
                        q = np.frombuffer(payload, dtype=np.int8)[: req["len"]]
                        params = SearchParams(
                            max_seqs=req.get("max_seqs", max_seqs_default))
                        hits = pref.query(q, params)
                        _send(conn, {"hits": hits})
                    elif req["cmd"] == "query_batch":
                        buf = np.frombuffer(payload, dtype=np.int8)
                        seqs = []
                        off = 0
                        for L in req["lens"]:
                            seqs.append(buf[off:off + L])
                            off += L
                        params = SearchParams(
                            max_seqs=req.get("max_seqs", max_seqs_default))
                        hits = pref.query_batch(seqs, params)
                        _send(conn, {"hits_batch": hits})
                    else:
                        _send(conn, {"error": f"unknown cmd {req['cmd']}"})
            finally:
                conn.close()
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


class IndexServerClient:
    def __init__(self, socket_path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(socket_path)

    def ping(self) -> dict:
        _send(self.sock, {"cmd": "ping"})
        resp, _ = _recv(self.sock)
        return resp

    def query(self, q_ss: np.ndarray, max_seqs: int = 1000) -> List[Tuple[int, int]]:
        q = np.ascontiguousarray(q_ss, dtype=np.int8)
        _send(self.sock, {"cmd": "query", "len": len(q), "max_seqs": max_seqs},
              q.tobytes())
        resp, _ = _recv(self.sock)
        return [(int(k), int(s)) for k, s in resp["hits"]]

    def query_batch(self, seqs, max_seqs: int = 1000):
        arrs = [np.ascontiguousarray(s, dtype=np.int8) for s in seqs]
        _send(self.sock, {"cmd": "query_batch",
                          "lens": [len(a) for a in arrs],
                          "max_seqs": max_seqs},
              b"".join(a.tobytes() for a in arrs))
        resp, _ = _recv(self.sock)
        return [[(int(k), int(s)) for k, s in hits]
                for hits in resp["hits_batch"]]

    def shutdown(self):
        _send(self.sock, {"cmd": "shutdown"})
        _recv(self.sock)

    def close(self):
        self.sock.close()


def server_prefilter(qdb, socket_path: str, max_seqs: int):
    """Prefilter via a running index server (client side): one round trip
    carries the whole query batch."""
    client = IndexServerClient(socket_path)
    try:
        seqs = [np.asarray(qdb.get_ss(qi)) for qi in range(qdb.size)]
        hits = client.query_batch(seqs, max_seqs)
        return {int(qdb.keys[qi]): [k for k, _ in hits[qi]]
                for qi in range(qdb.size)}
    finally:
        client.close()

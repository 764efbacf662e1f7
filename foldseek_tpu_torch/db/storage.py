"""Array-native structure database.

The reference stores a "database" as concatenated \\0-terminated records plus
index/dbtype/lookup side files (reference: lib/mmseqs/src/commons/DBReader.h:58-62,
SURVEY Appendix B). We keep the same *logical* artifact set — amino-acid
sequences, 3Di sequences, C-alpha coordinates, headers, key<->name lookup —
but store them as flat, memory-mappable numpy arrays so a DB can be mmap'd
into host RAM and sliced directly into per-host HBM shards without any
conversion pass:

  <db>/manifest.json    metadata: version, kind, counts
  <db>/aa.npy           int8  [total_residues]   numeric AA codes (21-letter)
  <db>/ss.npy           int8  [total_residues]   numeric 3Di codes
  <db>/mask.npy         uint8 [total_residues]   1 where residue is lowercase-
                                                 masked (b-factor masking)
  <db>/ca.npy           float32 [total_residues, 3]
  <db>/offsets.npy      int64 [n_entries + 1]
  <db>/keys.npy         uint32 [n_entries]
  <db>/names.txt        entry names, one per line (lookup)
  <db>/headers.txt      full headers, one per line
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import List, Mapping, Optional

import numpy as np

from ..ops.matrices import AA2NUM, ALPHABET
from ..utils.log import add_count, record_count

DB_VERSION = 1


@dataclass
class StructDB:
    path: str
    aa: np.ndarray       # int8 [R]
    ss: np.ndarray       # int8 [R]
    mask: np.ndarray     # uint8 [R]
    ca: Optional[np.ndarray]  # float32 [R, 3] or None
    offsets: np.ndarray  # int64 [n+1]
    keys: np.ndarray     # uint32 [n]
    names: List[str]
    headers: List[str]
    # source-file (complex) id per entry — the reference's .lookup third
    # column (structcreatedb.cpp lookup stream); chains of one structure
    # file share an id, which is what groups complexes for multimer search
    fileids: Optional[np.ndarray] = None  # uint32 [n]
    # source file names by file id (the reference's .source file)
    sources: Optional[List[str]] = None
    # (the keys array, its length, the read-only map built from it): see
    # key_to_index
    _key_map: Optional[tuple] = field(default=None, init=False, repr=False,
                                      compare=False)

    @property
    def size(self) -> int:
        return len(self.keys)

    @property
    def total_residues(self) -> int:
        return int(self.offsets[-1])

    def entry_len(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def get_aa(self, i: int) -> np.ndarray:
        return self.aa[self.offsets[i]:self.offsets[i + 1]]

    def get_ss(self, i: int) -> np.ndarray:
        return self.ss[self.offsets[i]:self.offsets[i + 1]]

    def get_ca(self, i: int) -> np.ndarray:
        return self.ca[self.offsets[i]:self.offsets[i + 1]]

    def get_aa_str(self, i: int) -> str:
        s = "".join(ALPHABET[v] for v in self.get_aa(i))
        return _apply_mask(s, self.mask[self.offsets[i]:self.offsets[i + 1]])

    def get_ss_str(self, i: int) -> str:
        s = "".join(ALPHABET[v] for v in self.get_ss(i))
        return _apply_mask(s, self.mask[self.offsets[i]:self.offsets[i + 1]])

    def key_to_index(self) -> Mapping[int, int]:
        """key -> row, the last row where a key repeats, as a read-only
        mapping built once per `keys` array: a DB searched call after call
        (the index server, a benchmark's or a user's loop) builds it once,
        and a `keys` replaced by another array gets a map of its own.
        Counts: `key_maps.built` the keys of each map built,
        `key_maps.reused` the calls answered from the stored one."""
        keys = self.keys
        held = self._key_map
        if held is not None and held[0] is keys and held[1] == len(keys):
            add_count("key_maps.reused")
            return held[2]
        n = len(keys)
        built = MappingProxyType(dict(zip(np.asarray(keys).tolist(),
                                          range(n))))
        self._key_map = (keys, n, built)
        record_count("key_maps.built", n)
        return built

    def max_len(self) -> int:
        return int(self.lengths().max()) if self.size else 0

    def row_view(self, start: int, end: int) -> "StructDB":
        """Rows [start, end) as a DB of their own, clipped to the DB's
        rows: every array a slice of this DB's (no copy), the offsets
        rebased to 0 and the path kept (an index at the path describes
        this DB, not the view, so `load_index` declines it)."""
        start, end = min(start, self.size), min(end, self.size)
        o0, o1 = int(self.offsets[start]), int(self.offsets[end])
        return StructDB(
            path=self.path, aa=self.aa[o0:o1], ss=self.ss[o0:o1],
            mask=self.mask[o0:o1],
            ca=None if self.ca is None else self.ca[o0:o1],
            offsets=self.offsets[start:end + 1] - o0,
            keys=self.keys[start:end], names=self.names[start:end],
            headers=self.headers[start:end],
            fileids=(None if self.fileids is None
                     else self.fileids[start:end]),
            sources=self.sources)


def _apply_mask(s: str, mask: np.ndarray) -> str:
    if not mask.any():
        return s
    return "".join(c.lower() if m else c for c, m in zip(s, mask))


class StructDBWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._aa: List[np.ndarray] = []
        self._ss: List[np.ndarray] = []
        self._mask: List[np.ndarray] = []
        self._ca: List[np.ndarray] = []
        self._lens: List[int] = []
        self._keys: List[int] = []
        self._names: List[str] = []
        self._headers: List[str] = []
        self._fileids: List[int] = []
        self._has_ca = True
        self.sources: List[str] = []

    def add_entry(self, key: int, name: str, header: str,
                  aa_num: np.ndarray, ss_num: np.ndarray,
                  ca: Optional[np.ndarray] = None,
                  mask: Optional[np.ndarray] = None,
                  file_id: int = 0):
        """ca may be None for sequence-only DBs (ProstT5-predicted 3Di — the
        reference's FASTA createdb writes no _ca DB either); structure gates
        are disabled downstream when coordinates are absent."""
        L = len(aa_num)
        if ca is None:
            self._has_ca = False
            ca = np.zeros((L, 3), dtype=np.float32)
        assert len(ss_num) == L and ca.shape == (L, 3)
        self._fileids.append(file_id)
        self._aa.append(np.asarray(aa_num, dtype=np.int8))
        self._ss.append(np.asarray(ss_num, dtype=np.int8))
        self._mask.append(
            np.zeros(L, dtype=np.uint8) if mask is None else np.asarray(mask, dtype=np.uint8))
        self._ca.append(np.asarray(ca, dtype=np.float32))
        self._lens.append(L)
        self._keys.append(key)
        self._names.append(name)
        self._headers.append(header)

    def finish(self) -> StructDB:
        n = len(self._keys)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self._lens, out=offsets[1:])
        aa = np.concatenate(self._aa) if n else np.zeros(0, np.int8)
        ss = np.concatenate(self._ss) if n else np.zeros(0, np.int8)
        mask = np.concatenate(self._mask) if n else np.zeros(0, np.uint8)
        ca = np.concatenate(self._ca) if n else np.zeros((0, 3), np.float32)
        np.save(os.path.join(self.path, "aa.npy"), aa)
        np.save(os.path.join(self.path, "ss.npy"), ss)
        np.save(os.path.join(self.path, "mask.npy"), mask)
        if self._has_ca:
            np.save(os.path.join(self.path, "ca.npy"), ca)
        np.save(os.path.join(self.path, "offsets.npy"), offsets)
        np.save(os.path.join(self.path, "keys.npy"), np.asarray(self._keys, dtype=np.uint32))
        np.save(os.path.join(self.path, "fileids.npy"),
                np.asarray(self._fileids, dtype=np.uint32))
        with open(os.path.join(self.path, "names.txt"), "w") as f:
            f.write("\n".join(self._names) + ("\n" if n else ""))
        with open(os.path.join(self.path, "sources.txt"), "w") as f:
            f.write("\n".join(self.sources) + ("\n" if self.sources else ""))
        with open(os.path.join(self.path, "headers.txt"), "w") as f:
            f.write("\n".join(self._headers) + ("\n" if n else ""))
        with open(os.path.join(self.path, "manifest.json"), "w") as f:
            json.dump(
                {"version": DB_VERSION, "kind": "structure", "n_entries": n,
                 "total_residues": int(offsets[-1])}, f)
        return load_db(self.path)


def is_db(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "manifest.json"))


def load_db(path: str, mmap: bool = True) -> StructDB:
    mode = "r" if mmap else None
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["version"] == DB_VERSION

    def arr(name):
        return np.load(os.path.join(path, name), mmap_mode=mode)

    with open(os.path.join(path, "names.txt")) as f:
        names = f.read().splitlines()
    src_path = os.path.join(path, "sources.txt")
    sources = None
    if os.path.exists(src_path):
        with open(src_path) as f:
            sources = f.read().splitlines()
    with open(os.path.join(path, "headers.txt")) as f:
        headers = f.read().splitlines()
    ca_path = os.path.join(path, "ca.npy")
    fid_path = os.path.join(path, "fileids.npy")
    keys = arr("keys.npy")
    return StructDB(
        path=path,
        aa=arr("aa.npy"), ss=arr("ss.npy"), mask=arr("mask.npy"),
        ca=np.load(ca_path, mmap_mode=mode) if os.path.exists(ca_path) else None,
        offsets=arr("offsets.npy"), keys=keys,
        names=names, headers=headers,
        fileids=(np.load(fid_path, mmap_mode=mode) if os.path.exists(fid_path)
                 else np.zeros(len(keys), dtype=np.uint32)),
        sources=sources,
    )

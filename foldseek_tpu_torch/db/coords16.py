"""Lossy C-alpha coordinate codec — Coordinate16
(reference: src/commons/Coordinate16.h): per axis an int32 start in
milli-units followed by int16 deltas; falls back to raw float32 when any
delta overflows. 6 bytes/residue instead of 12 — the reference's RAM
headline for AFDB-scale DBs (README.md:95).

Byte-level note vs the reference's `_ca` payload: the reference quantizes
from gemmi's float64 coordinates with C truncation ((int)(x*1000),
structcreatedb.cpp:636), which drops one milli-Angstrom on roughly half
of all PDB 3-decimal values; our DB stores float32 and quantizes from
that, so ~1% of milli values differ by 1 (ours closer to the printed
source value — see test_convert2pdb_parity_vs_reference). The reference
also appends one uint8 marker byte per entry; round-trip compatibility
within each framework is exact either way. Copy of
`foldseek_tpu/db/coords16.py`, for `compressca` and `createdb
--coord-store-mode 2`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

INT16_MIN, INT16_MAX = -32768, 32767


def encode_ca(ca: np.ndarray) -> Tuple[bytes, bool]:
    """[L, 3] float32 -> (payload, compressed?). Falls back to raw float32
    planes (x..., y..., z...) when a per-axis delta overflows int16."""
    ca = np.asarray(ca, dtype=np.float32)
    L = len(ca)
    milli = (ca * 1000).astype(np.int32)
    out = bytearray()
    for axis in range(3):
        v = milli[:, axis]
        diffs = np.diff(v.astype(np.int64))
        if len(diffs) and (diffs.max() > INT16_MAX or diffs.min() < INT16_MIN):
            planes = np.concatenate([ca[:, 0], ca[:, 1], ca[:, 2]])
            return planes.astype(np.float32).tobytes(), False
        out += int(v[0]).to_bytes(4, "little", signed=True)
        out += diffs.astype("<i2").tobytes()
    return bytes(out), True


def decode_ca(payload: bytes, L: int) -> np.ndarray:
    """Inverse of encode_ca -> [L, 3] float32."""
    if len(payload) >= L * 3 * 4:
        planes = np.frombuffer(payload, dtype=np.float32, count=3 * L)
        return np.stack([planes[:L], planes[L:2 * L], planes[2 * L:]], axis=1)
    out = np.empty((L, 3), dtype=np.float32)
    pos = 0
    for axis in range(3):
        start = int.from_bytes(payload[pos:pos + 4], "little", signed=True)
        pos += 4
        diffs = np.frombuffer(payload, dtype="<i2", count=L - 1, offset=pos)
        pos += 2 * (L - 1)
        vals = start + np.concatenate(([0], np.cumsum(diffs, dtype=np.int64)))
        out[:, axis] = vals / 1000.0
    return out

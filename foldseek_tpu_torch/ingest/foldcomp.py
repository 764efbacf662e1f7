"""Foldcomp (.fcz) decoder: torsion-compressed backbones -> coordinates.

Implements read + decompress of the FCMP format so `createdb` can ingest
foldcomp files/databases like the reference does
(reference: lib/foldcomp/src/foldcomp.cpp:904-1036 read,
:779-901 decompress, :167-247 forward NeRF, :248-273 reverse pass,
lib/foldcomp/src/nerf.cpp:39-105 place_atom, :342-380 reversed
reconstruction; lib/foldcomp/src/atom_coordinate.cpp:145-166 weighted
average of the two passes).

Only the atoms needed downstream are reconstructed: the N/CA/C backbone
plus, from the sidechain torsion stream, O and CB (foldseek's 3Di encoder
consumes exactly N/CA/C/CB; O is required because CB is placed off the
O-C-CA frame, foldcomp.cpp's AAS sidechain order places O first then CB,
lib/foldcomp/src/amino_acid.h:72-74).

All float math is float32 to track the reference's C floats.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"FCMP"

# CompressedFileHeader, 72 bytes (lib/foldcomp/src/foldcomp.h:118-136);
# natural C alignment inserts 2-byte pads after `chain` and `lastResidue`
_HEADER_FMT = "<HHHHBc2xIcc2xI6f6f"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 72

# residue code order (lib/foldcomp/src/utility.h:133-204)
_INT_TO_AA = "ARNDCQEGHILKMFPSTWYV" + "BZ*X"

# sidechain torsion counts consumed per residue from the flat torsion
# stream (lib/foldcomp/src/foldcomp.cpp:1761-1807); equals the number of
# non-backbone atoms (O + sidechain) placed per residue
_TORSION_NUM = {
    "A": 2, "R": 8, "N": 5, "D": 5, "C": 3, "Q": 6, "E": 6, "G": 1,
    "H": 7, "I": 5, "L": 5, "K": 6, "M": 5, "F": 8, "P": 4, "S": 3,
    "T": 4, "W": 11, "Y": 9, "V": 4,
}

# per-residue geometry for O and CB placement
# (lib/foldcomp/src/amino_acid.h:75-399: C_O / CA_C_O, CA_CB / C_CA_CB)
_O_GEOM = {
    "A": (1.23, 120.31), "R": (1.23, 119.745), "N": (1.23, 120.313),
    "D": (1.23, 121.051), "C": (1.23, 120.063), "Q": (1.23, 120.211),
    "E": (1.23, 120.594), "G": (1.23, 120.522), "H": (1.23, 120.548),
    "I": (1.235, 120.393), "L": (1.235, 120.211), "K": (1.23, 120.54),
    "M": (1.23, 120.148), "F": (1.23, 120.283), "P": (1.23, 120.6),
    "S": (1.23, 120.475), "T": (1.23, 120.252), "W": (1.23, 120.178),
    "Y": (1.235, 120.608), "V": (1.235, 120.472),
}
_CB_GEOM = {
    "A": (1.52, 110.852), "R": (1.53, 110.579), "N": (1.52, 110.852),
    "D": (1.53, 110.871), "C": (1.53, 111.078), "Q": (1.53, 109.5),
    "E": (1.53, 110.538), "H": (1.53, 111.329), "I": (1.54, 111.983),
    "L": (1.53, 110.418), "K": (1.53, 109.5), "M": (1.53, 110.833),
    "F": (1.53, 110.846), "P": (1.53, 111.372), "S": (1.53, 110.248),
    "T": (1.53, 110.075), "W": (1.53, 110.852), "Y": (1.53, 110.852),
    "V": (1.54, 111.381),
}

# backbone bond lengths (lib/foldcomp/src/nerf.h:37-43)
_N_TO_CA = np.float32(1.4581)
_PRO_N_TO_CA = np.float32(1.353)
_CA_TO_C = np.float32(1.5281)
_C_TO_N = np.float32(1.3311)

_DEG = np.float32(np.pi / 180.0)


@dataclass
class FoldcompStructure:
    title: str
    chain: str
    residues: str          # one-letter AA codes
    n: np.ndarray          # [L, 3] float32
    ca: np.ndarray
    c: np.ndarray
    o: np.ndarray
    cb: np.ndarray         # NaN rows where absent (GLY/unknown)


def is_fcz(data: bytes) -> bool:
    return data[:4] == MAGIC


def _place_atom(a, b, c, blen, bang_deg, tors_deg):
    """NeRF atom placement (lib/foldcomp/src/nerf.cpp:39-105)."""
    ab = b - a
    bc = c - b
    bcn = bc / np.sqrt(np.float32(bc @ bc))
    bang = np.float32(bang_deg) * _DEG
    tors = np.float32(tors_deg) * _DEG
    d = np.array([-blen * np.cos(bang),
                  blen * np.cos(tors) * np.sin(bang),
                  blen * np.sin(tors) * np.sin(bang)], dtype=np.float32)
    n = np.cross(ab, bcn).astype(np.float32)
    n /= np.sqrt(np.float32(n @ n))
    nbc = np.cross(n, bcn).astype(np.float32)
    m = np.stack([bcn, nbc, n], axis=1)  # columns
    return (m @ d + c).astype(np.float32)


def _forward_segment(prev3: np.ndarray, residues: str, tors: np.ndarray,
                     bang: np.ndarray) -> np.ndarray:
    """Forward NeRF over one anchor segment
    (lib/foldcomp/src/foldcomp.cpp:167-247).

    prev3: [3,3] previous N/CA/C; tors/bang: [n,3] continuized
    (psi,omega,phi) / (ca_c_n, c_n_ca, n_ca_c) per backbone row. Places
    rows 1..n-1 using row i-1's angles; the PRO bond-length check uses row
    i-1's residue as the reference does (foldcomp.cpp:204-213)."""
    n = len(residues)
    out = np.empty((3 * n, 3), dtype=np.float32)
    out[:3] = prev3
    for i in range(n - 1):
        a, b, c = out[3 * i], out[3 * i + 1], out[3 * i + 2]
        psi, omega, phi = tors[i]
        ca_c_n, c_n_ca, n_ca_c = bang[i]
        atom_n = _place_atom(a, b, c, _C_TO_N, ca_c_n, psi)
        n_ca = _PRO_N_TO_CA if residues[i] == "P" else _N_TO_CA
        atom_ca = _place_atom(b, c, atom_n, n_ca, c_n_ca, omega)
        atom_c = _place_atom(c, atom_n, atom_ca, _CA_TO_C, n_ca_c, phi)
        out[3 * i + 3] = atom_n
        out[3 * i + 4] = atom_ca
        out[3 * i + 5] = atom_c
    return out


def _bond_angles(coords: np.ndarray) -> np.ndarray:
    """Interior angles in degrees (lib/foldcomp/src/nerf.cpp:495-509)."""
    d1 = coords[:-2] - coords[1:-1]
    d2 = coords[2:] - coords[1:-1]
    num = np.sum(d1 * d2, axis=1)
    den = np.sqrt(np.sum(d1 * d1, axis=1) * np.sum(d2 * d2, axis=1))
    return (np.arccos(num / den) * np.float32(180.0 / np.pi)).astype(np.float32)


def _reverse_segment(fwd: np.ndarray, anchor3: np.ndarray,
                     torsions: np.ndarray) -> np.ndarray:
    """Reverse-direction NeRF anchored at the segment end, then
    position-weighted average with the forward pass
    (foldcomp.cpp:248-273, nerf.cpp:342-380, atom_coordinate.cpp:145-166)."""
    total = fwd.shape[0]
    bang = _bond_angles(fwd)                    # total-2 entries
    rev = fwd[::-1].copy()
    rev[:3] = anchor3[::-1]
    tors_r = torsions[::-1]
    bang_r = bang[::-1]
    # atom kinds cycle N,CA,C forward; reversed bond lengths repeat
    # C_TO_N, CA_TO_C, N_TO_CA by position (bond between reversed[i+2]
    # and reversed[i+3]; no PRO special-case in the reverse direction)
    lens = np.array([_C_TO_N, _CA_TO_C, _N_TO_CA], dtype=np.float32)
    for i in range(total - 3):
        rev[i + 3] = _place_atom(rev[i], rev[i + 1], rev[i + 2],
                                 lens[i % 3], bang_r[i + 1], tors_r[i])
    back = rev[::-1]
    w = (np.arange(total, dtype=np.float32) / np.float32(total))[:, None]
    return (fwd * (1.0 - w) + back * w).astype(np.float32)


def decode_fcz(data: bytes) -> FoldcompStructure:
    if not is_fcz(data):
        raise ValueError("not a foldcomp (FCMP) entry")
    off = 4
    (n_residue, _n_atom, _idx_res, _idx_atom, n_anchor, chain,
     n_sc_torsion, first_res, last_res, len_title,
     *disc) = struct.unpack_from(_HEADER_FMT, data, off)
    off += _HEADER_SIZE
    mins = np.array(disc[:6], dtype=np.float32)
    cont_fs = np.array(disc[6:], dtype=np.float32)

    anchor_idx = np.frombuffer(data, np.int32, n_anchor, off).tolist()
    off += 4 * n_anchor
    title = data[off:off + len_title].decode("utf-8", "replace")
    off += len_title
    prev3 = np.frombuffer(data, np.float32, 9, off).reshape(3, 3).copy()
    off += 36
    anchor_coords = []
    for _ in range(n_anchor - 2):
        anchor_coords.append(
            np.frombuffer(data, np.float32, 9, off).reshape(3, 3).copy())
        off += 36
    anchor_coords.append(
        np.frombuffer(data, np.float32, 9, off).reshape(3, 3).copy())
    off += 36
    has_oxt = data[off]
    off += 1 + 12  # hasOXT char + OXT float[3]
    del has_oxt

    # backbone rows: 8-byte bit-packed records
    # (lib/foldcomp/src/foldcomp.cpp:60-77)
    raw = np.frombuffer(data, np.uint8, 8 * n_residue, off)
    off += 8 * n_residue
    b = raw.reshape(n_residue, 8).astype(np.uint32)
    res_idx = (b[:, 0] & 0xF8) >> 3
    omega_d = ((b[:, 0] & 0x07) << 8) | b[:, 1]
    psi_d = (b[:, 2] << 4) | (b[:, 3] >> 4)
    phi_d = ((b[:, 3] & 0x0F) << 8) | b[:, 4]
    ca_c_n_d, c_n_ca_d, n_ca_c_d = b[:, 5], b[:, 6], b[:, 7]

    residues = "".join(_INT_TO_AA[i] if i < len(_INT_TO_AA) else "X"
                       for i in res_idx)

    # continuize: min + v * cont_f (foldcomp.cpp:155-158); header order
    # phi, psi, omega, n_ca_c, ca_c_n, c_n_ca (foldcomp.h:132-134)
    phi = mins[0] + phi_d.astype(np.float32) * cont_fs[0]
    psi = mins[1] + psi_d.astype(np.float32) * cont_fs[1]
    omega = mins[2] + omega_d.astype(np.float32) * cont_fs[2]
    n_ca_c = mins[3] + n_ca_c_d.astype(np.float32) * cont_fs[3]
    ca_c_n = mins[4] + ca_c_n_d.astype(np.float32) * cont_fs[4]
    c_n_ca = mins[5] + c_n_ca_d.astype(np.float32) * cont_fs[5]
    tors = np.stack([psi, omega, phi], axis=1)
    bang = np.stack([ca_c_n, c_n_ca, n_ca_c], axis=1)
    # flat torsion stream used by the reverse pass: (psi,omega,phi) per
    # row for rows 0..n-2 (foldcomp.cpp:788-793)
    flat_tors = tors[:n_residue - 1].reshape(-1)

    sc_tors_d = np.frombuffer(data, np.uint8, n_sc_torsion, off)
    off += n_sc_torsion
    # fixed -180..180 discretizer, 255 bins (foldcomp.cpp:350,
    # discretizer.h:89-106)
    sc_tors = (np.float32(-180.0)
               + sc_tors_d.astype(np.float32) * np.float32(360.0 / 255.0))

    # temp factors follow (min, cont_f floats + nResidue bytes) — unused

    # anchored segment reconstruction (foldcomp.cpp:812-861)
    coords = []
    prev = prev3
    n_all_anchor = n_anchor
    max_row = n_residue - 1
    for i in range(n_all_anchor - 1):
        first = min(anchor_idx[i], max_row)
        last = min(anchor_idx[i + 1] + 1, max_row)
        rows = list(range(first, last))
        if i == n_all_anchor - 2:
            rows.append(n_residue - 1)
        seg_res = "".join(residues[r] for r in rows)
        seg_tors = tors[rows]
        seg_bang = bang[rows]
        fwd = _forward_segment(prev, seg_res, seg_tors, seg_bang)
        t_max = len(flat_tors) - 1
        t_first = min(3 * anchor_idx[i], t_max)
        t_last = min(3 * anchor_idx[i + 1], t_max)
        seg_flat = flat_tors[t_first:t_last]
        if i == n_all_anchor - 2:
            seg_flat = np.concatenate([seg_flat, flat_tors[-1:]])
        avg = _reverse_segment(fwd, anchor_coords[i], seg_flat)
        if i != n_all_anchor - 2:
            coords.append(avg[:-3])
        else:
            coords.append(avg)
        prev = avg[-3:]
    atoms = np.concatenate(coords, axis=0)
    if atoms.shape[0] != 3 * n_residue:
        raise ValueError(
            f"decoded {atoms.shape[0]} backbone atoms, expected {3 * n_residue}")
    bb = atoms.reshape(n_residue, 3, 3)
    n_xyz, ca_xyz, c_xyz = bb[:, 0], bb[:, 1], bb[:, 2]

    # O and CB from the first two sidechain torsions of each residue
    # (nerf.cpp:106-155 with amino_acid.h atom order O then CB)
    o_xyz = np.full((n_residue, 3), np.nan, dtype=np.float32)
    cb_xyz = np.full((n_residue, 3), np.nan, dtype=np.float32)
    ti = 0
    for r, aa in enumerate(residues):
        cnt = _TORSION_NUM.get(aa, 0)
        if cnt >= 1 and ti < len(sc_tors) and aa in _O_GEOM:
            blen, bangle = _O_GEOM[aa]
            o_xyz[r] = _place_atom(n_xyz[r], ca_xyz[r], c_xyz[r],
                                   np.float32(blen), bangle, sc_tors[ti])
            if cnt >= 2 and ti + 1 < len(sc_tors) and aa in _CB_GEOM:
                blen, bangle = _CB_GEOM[aa]
                cb_xyz[r] = _place_atom(o_xyz[r], c_xyz[r], ca_xyz[r],
                                        np.float32(blen), bangle,
                                        sc_tors[ti + 1])
        ti += cnt

    return FoldcompStructure(
        title=title, chain=chain.decode("ascii", "replace"),
        residues=residues, n=n_xyz, ca=ca_xyz, c=c_xyz, o=o_xyz, cb=cb_xyz)


def read_fcz(path: str) -> FoldcompStructure:
    with open(path, "rb") as f:
        return decode_fcz(f.read())


def to_structure(st: FoldcompStructure, name: str):
    """Adapt a decoded entry to the ingest Structure/Chain interface so
    createdb treats foldcomp input like any parsed PDB
    (reference: src/strucclustutils/GemmiWrapper.cpp:679-758 keeps
    N/CA/C/CB + amino acid per residue from the decompressed atoms)."""
    from .pdb import Chain, Structure
    L = len(st.residues)
    ch = Chain(name=st.chain if st.chain.strip() else "A", model=1,
               aa=st.residues, ca=st.ca, cb=st.cb, n=st.n, c=st.c,
               bfactor=np.zeros(L, dtype=np.float32))
    return Structure(name=name, title=st.title, model_count=1, chains=[ch])


def iter_foldcomp_db(path: str):
    """Yield (name, FoldcompStructure) from a foldcomp/mmseqs-style DB
    (data file + .index with 'key\\toffset\\tlength' lines + .lookup names)."""
    names = {}
    lookup = path + ".lookup"
    import os
    if os.path.exists(lookup):
        for line in open(lookup):
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                names[int(parts[0])] = parts[1]
    data = open(path, "rb").read()
    for line in open(path + ".index"):
        key_s, off_s, len_s = line.split("\t")[:3]
        key, off, ln = int(key_s), int(off_s), int(len_s)
        chunk = data[off:off + ln].rstrip(b"\x00")
        st = decode_fcz(chunk)
        fallback = st.title or f"{os.path.basename(path)}_{key}"
        yield names.get(key, fallback), st


# ---------------------------------------------------------------------------
# write side (compress): mirrors Foldcomp::preprocess/compress/writeStream
# (lib/foldcomp/src/foldcomp.cpp:450-606,1038-1110) for backbone-only input —
# the reference foldseek export passes N/CA/C per residue only
# (src/strucclustutils/GemmiWrapper.cpp:895-945, CB commented out).

_AA_TO_INT = {c: i for i, c in enumerate(_INT_TO_AA)}


def _torsions_f32(p: np.ndarray) -> np.ndarray:
    """Consecutive 4-atom dihedrals with foldcomp's sign convention
    (lib/foldcomp/src/torsion_angle.cpp:32-100), float32 math."""
    p = np.asarray(p, dtype=np.float32)
    d1 = p[1:-2] - p[:-3]
    d2 = p[2:-1] - p[1:-2]
    d3 = p[3:] - p[2:-1]
    u1 = np.cross(d1, d2).astype(np.float32)
    u2 = np.cross(d2, d3).astype(np.float32)
    num = (u1 * u2).sum(1)
    den = np.sqrt((u1 * u1).sum(1) * (u2 * u2).sum(1)).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        cos = num / den
    t = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).astype(np.float32)
    t = np.where(np.isnan(cos), np.where(cos < 0, 180.0, 0.0), t)
    sign = (u1 * np.cross(u2, d2)).sum(1)
    return np.where(sign < 0, -t, t).astype(np.float32)


def _angles_f32(p: np.ndarray) -> np.ndarray:
    """Interior bond angles in degrees (nerf.cpp getBondAngles)."""
    p = np.asarray(p, dtype=np.float32)
    d1 = p[:-2] - p[1:-1]
    d2 = p[2:] - p[1:-1]
    num = (d1 * d2).sum(1)
    den = np.sqrt((d1 * d1).sum(1) * (d2 * d2).sum(1))
    return np.degrees(np.arccos(num / den)).astype(np.float32)


class _Disc:
    """Discretizer(values, n_bin) (lib/foldcomp/src/discretizer.cpp:22-53):
    vector discretize rounds (+0.5 then uint truncation)."""

    def __init__(self, values: np.ndarray, n_bin: int):
        v = np.asarray(values, dtype=np.float32)
        self.min = np.float32(v.min()) if len(v) else np.float32(0)
        vmax = np.float32(v.max()) if len(v) else np.float32(0)
        span = np.float32(vmax - self.min)
        with np.errstate(divide="ignore"):
            self.disc_f = np.float32(n_bin) / span if span != 0 else np.float32(0)
            self.cont_f = span / np.float32(n_bin)

    def disc(self, v: np.ndarray) -> np.ndarray:
        out = ((np.asarray(v, np.float32) - self.min) * self.disc_f
               + np.float32(0.5))
        return np.nan_to_num(out).astype(np.uint32)


def encode_fcz(n_xyz: np.ndarray, ca_xyz: np.ndarray, c_xyz: np.ndarray,
               residues: str, title: str = "", chain: str = "A",
               bfactor: np.ndarray = None, idx_residue: int = 0,
               idx_atom: int = 0, anchor_threshold: int = 25) -> bytes:
    """Backbone N/CA/C (+ per-residue CA b-factors) -> FCMP blob."""
    L = len(residues)
    bb = np.empty((3 * L, 3), dtype=np.float32)
    bb[0::3] = n_xyz
    bb[1::3] = ca_xyz
    bb[2::3] = c_xyz
    if bfactor is None:
        bfactor = np.zeros(L, dtype=np.float32)

    tors = _torsions_f32(bb)           # 3L-3 values: psi0, omega0, phi0, ...
    psi, omega, phi = tors[0::3], tors[1::3], tors[2::3]
    ang = _angles_f32(bb)              # 3L-2 values; split starts at index 1
    ca_c_n = ang[1::3]
    c_n_ca = ang[2::3]
    n_ca_c = ang[3::3]

    d_phi = _Disc(phi, 2 ** 12 - 1)
    d_psi = _Disc(psi, 2 ** 12 - 1)
    d_omega = _Disc(omega, 2 ** 11 - 1)
    d_ncac = _Disc(n_ca_c, 255)
    d_cacn = _Disc(ca_c_n, 255)
    d_cnca = _Disc(c_n_ca, 255)
    phi_d, psi_d, omega_d = d_phi.disc(phi), d_psi.disc(psi), d_omega.disc(omega)
    ncac_d, cacn_d, cnca_d = d_ncac.disc(n_ca_c), d_cacn.disc(ca_c_n), d_cnca.disc(c_n_ca)

    # anchors (foldcomp.cpp:745-761)
    n_inner = L // anchor_threshold
    n_all = n_inner + 2
    interval = L // (n_all - 1)
    anchor_idx = [i * interval for i in range(n_all - 1)] + [L - 1]

    # sidechain torsion stream: with only N/CA/C present every missing atom
    # resolves to the origin (findFirstAtomCoords, sidechain.cpp:140-147);
    # analytically the O torsion is dihedral(N,CA,C,origin) and every later
    # torsion is exactly 0 (degenerate cross products), scalar-discretized
    # WITHOUT rounding (discretizer.cpp:55, compress at foldcomp.cpp:533-537)
    sc_bytes = bytearray()
    cont = np.float32(255.0) / np.float32(360.0)
    for r in range(L):
        cnt = _TORSION_NUM.get(residues[r], 0)
        if cnt == 0:
            continue
        o_t = _torsions_f32(np.stack([n_xyz[r], ca_xyz[r], c_xyz[r],
                                      np.zeros(3)]).astype(np.float32))[0]
        sc_bytes.append(int((np.float32(o_t) + np.float32(180.0)) * cont) & 0xFF)
        zero_byte = int(np.float32(180.0) * cont) & 0xFF
        sc_bytes.extend([zero_byte] * (cnt - 1))

    d_temp = _Disc(np.asarray(bfactor, np.float32), 255)
    temp_d = d_temp.disc(bfactor)

    import struct as st
    out = bytearray()
    out += MAGIC
    # header stores the one-letter CHARACTERS (get_header passes
    # this->firstResidue = getOneLetterCode(...), a char)
    out += st.pack(_HEADER_FMT, L, 3 * L, idx_residue, idx_atom, n_all,
                   chain[:1].encode() or b"A", len(sc_bytes),
                   residues[0].encode(), residues[-1].encode(), len(title),
                   float(d_phi.min), float(d_psi.min), float(d_omega.min),
                   float(d_ncac.min), float(d_cacn.min), float(d_cnca.min),
                   float(d_phi.cont_f), float(d_psi.cont_f), float(d_omega.cont_f),
                   float(d_ncac.cont_f), float(d_cacn.cont_f), float(d_cnca.cont_f))
    out += np.asarray(anchor_idx, dtype=np.int32).tobytes()
    out += title.encode()
    for ai in anchor_idx:
        out += np.asarray([n_xyz[ai], ca_xyz[ai], c_xyz[ai]],
                          dtype=np.float32).tobytes()
    out += b"\x00" + np.zeros(3, np.float32).tobytes()  # hasOXT + coords

    def row(i):
        if i < L - 1:
            rr = (_AA_TO_INT.get(residues[i], 23), int(omega_d[i]), int(psi_d[i]),
                  int(phi_d[i]), int(cacn_d[i]), int(cnca_d[i]), int(ncac_d[i]))
        else:
            rr = (_AA_TO_INT.get(residues[i], 23), 0, 0, 0, 0, 0, 0)
        res_i, om, ps, ph, cacn, cnca, ncac = rr
        b = bytearray(8)
        b[0] = ((res_i << 3) | ((om & 0x7FF) >> 8)) & 0xFF
        b[1] = om & 0xFF
        b[2] = (ps & 0xFFF) >> 4
        b[3] = (((ps & 0xF) << 4) | ((ph & 0xFFF) >> 8)) & 0xFF
        b[4] = ph & 0xFF
        b[5] = cacn & 0xFF
        b[6] = cnca & 0xFF
        b[7] = ncac & 0xFF
        return bytes(b)

    for i in range(L):
        out += row(i)
    out += bytes(sc_bytes)
    out += st.pack("<ff", float(d_temp.min), float(d_temp.cont_f))
    out += bytes(int(x) & 0xFF for x in temp_d)
    return bytes(out)


def write_foldcomp_db(db_entries, out_path: str):
    """entries: iterable of (name, blob). Writes data + .index + .lookup +
    .dbtype in the foldcomp/mmseqs container layout iter_foldcomp_db reads."""
    off = 0
    with open(out_path, "wb") as f, open(out_path + ".index", "w") as idx, \
            open(out_path + ".lookup", "w") as lk:
        for key, (name, blob) in enumerate(db_entries):
            f.write(blob)
            idx.write(f"{key}\t{off}\t{len(blob)}\n")
            lk.write(f"{key}\t{name}\t0\n")
            off += len(blob)
    with open(out_path + ".dbtype", "wb") as f:
        f.write(bytes([5, 0, 0, 0]))

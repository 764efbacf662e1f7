"""Backbone (N, C) reconstruction from a C-alpha-only trace — the PULCHRA
equivalent for 3Di featurization (reference: src/strucclustutils/
PulchraWrapper.cpp rebuildBackbone -> lib/pulchra/pulchra.cpp
pulchra_rebuild_backbone; used by createdb for C-alpha-only chains,
structcreatedb.cpp:504-518).

PULCHRA-parity path: per residue, the C-alpha 4-mer (i-2..i+1) is binned by
(r13_1, r13_2, signed r14) (pulchra.cpp:299-338), the nearest entry of the
statistical N/C/O table (lib/pulchra/nco_data.h, converted offline by
tools/convert_pulchra_data.py — pre-proline residues use the separate
nco_stat_pro table) is superimposed onto the actual 4-mer, and the stored
C(i-1)/N(i) template atoms are transformed out (pulchra.cpp:339-462).
Chain ends are extended by self-superposition first (prepare_rbins
:256-297). A fitted linear-frame model remains as the fallback for chains
with gaps/NaNs or fewer than 5 residues.
"""
from __future__ import annotations

import os

import numpy as np

# linear fallback — rows: [intercept, d13]; columns: local-frame coords
COEF_N = np.array([[2.0083221, -0.71668568, -0.42192367],
                   [-0.20163844, 0.06665476, -0.12115237]])
COEF_C = np.array([[0.46406392, 2.89314828, 1.56757947],
                   [0.05348795, -0.46972032, -0.05617521]])

PROLINE = 12  # ALPHABET.index('P')

_NCO = None


def _load_nco():
    global _NCO
    if _NCO is None:
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "pulchra_nco.npz")
        data = np.load(path)
        _NCO = (data["bins"].astype(np.float64), data["data"],
                data["bins_pro"].astype(np.float64), data["data_pro"])
    return _NCO


def _kabsch(src: np.ndarray, dst: np.ndarray):
    """Proper rotation R + translation mapping src points onto dst
    (the pulchra superimpose2 transform)."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    return R, cd - R @ cs


def _transform(R, t, pts):
    return pts @ R.T + t


def _nearest_entry(bins_table, b1, b2, b3):
    cost = (np.abs(bins_table[:, 0] - b1) + np.abs(bins_table[:, 1] - b2)
            + 0.2 * np.abs(bins_table[:, 2] - b3))
    return int(np.argmin(cost))


def rebuild_backbone(ca: np.ndarray, aa: np.ndarray = None):
    """[L, 3] CA trace -> (n, c) float32 arrays [L, 3].

    aa: optional residue identities — a string, char array, or numeric
    ALPHABET codes — for the pre-proline statistical table. Falls back to
    the linear model on chains with gaps or length < 5."""
    ca = np.asarray(ca, dtype=np.float64)
    L = len(ca)
    if L < 5 or np.isnan(ca).any():
        return _rebuild_linear(ca)
    if aa is None:
        is_pro = None
    elif isinstance(aa, str):
        is_pro = np.frombuffer(aa.encode("latin1"), dtype=np.uint8) == ord("P")
    else:
        arr = np.asarray(aa)
        if arr.dtype.kind in "US":
            is_pro = arr == "P"
        else:
            is_pro = arr == PROLINE
    return _rebuild_pulchra(ca, is_pro)


def _rebuild_pulchra(ca: np.ndarray, is_pro):
    bins_t, data_t, bins_p, data_p = _load_nco()
    L = len(ca)
    # extended trace: ext[k] = ca[k-2]; ends rebuilt by self-superposition
    ext = np.empty((L + 4, 3))
    ext[2:L + 2] = ca
    R, t = _kabsch(ca[2:5], ca[0:3])
    ext[0:2] = _transform(R, t, ca[0:2])
    R, t = _kabsch(ca[L - 5:L - 2], ca[L - 3:L])
    ext[L + 2:L + 4] = _transform(R, t, ca[L - 2:L])

    # 4-mer features for i in [0, L]: ca(i-2), ca(i-1), ca(i), ca(i+1)
    a = ext[0:L + 1]      # ca[i-2]
    b = ext[1:L + 2]      # ca[i-1]
    c3 = ext[2:L + 3]     # ca[i]
    d4 = ext[3:L + 4]     # ca[i+1]
    r13_1 = np.linalg.norm(c3 - a, axis=1)
    r13_2 = np.linalg.norm(d4 - b, axis=1)
    hand = np.einsum("ij,ij->i", np.cross(b - a, c3 - b), d4 - c3)
    r14 = np.where(hand > 0, 1.0, -1.0) * np.linalg.norm(d4 - a, axis=1)
    bin1 = np.clip(((r13_1 - 4.6) / 0.3).astype(np.int64), 0, 9)
    bin2 = np.clip(((r13_2 - 4.6) / 0.3).astype(np.int64), 0, 9)
    bin3 = np.clip(((r14 + 11.0) / 0.3).astype(np.int64), 0, 73)

    n_out = np.full((len(ca), 3), np.nan)
    c_out = np.full((len(ca), 3), np.nan)
    for i in range(L + 1):
        pre_pro = (is_pro is not None and i > 0 and i - 1 < len(is_pro)
                   and bool(is_pro[i - 1]))
        bt, dt = (bins_p, data_p) if pre_pro else (bins_t, data_t)
        e = _nearest_entry(bt, bin1[i], bin2[i], bin3[i])
        quad = np.stack([a[i], b[i], c3[i], d4[i]])
        R, t = _kabsch(dt[e, 0:4], quad)
        atoms = _transform(R, t, dt[e, 4:8])
        if i > 0:
            c_out[i - 1] = atoms[0]   # template row 4 = C(i-1)
        if i < L:
            n_out[i] = atoms[2]       # template row 6 = N(i)
    return n_out.astype(np.float32), c_out.astype(np.float32)


def _rebuild_linear(ca: np.ndarray):
    """Fallback: place N/C in the bisector/cross/normal local frame with
    coefficients linear in |CA(i+1)-CA(i-1)| (least-squares fit on the SCOP
    examples; ~0.11 A (N) / 0.21 A (C) residual)."""
    L = len(ca)
    n_out = np.full((L, 3), np.nan)
    c_out = np.full((L, 3), np.nan)
    for i in range(1, L - 1):
        if np.isnan(ca[i - 1:i + 2]).any():
            continue
        v1 = ca[i + 1] - ca[i]
        v2 = ca[i - 1] - ca[i]
        l1 = np.linalg.norm(v1)
        l2 = np.linalg.norm(v2)
        if l1 < 1e-6 or l2 < 1e-6:
            continue
        n1 = v1 / l1
        n2 = v2 / l2
        b = n1 + n2
        nb = np.linalg.norm(b)
        x = np.cross(n1, n2)
        nx = np.linalg.norm(x)
        if nb < 1e-3 or nx < 1e-3:
            continue
        b /= nb
        x /= nx
        y = np.cross(b, x)
        frame = np.stack([b, x, y])  # rows are basis vectors
        d13 = np.linalg.norm(ca[i + 1] - ca[i - 1])
        feat = np.array([1.0, d13])
        n_out[i] = ca[i] + (feat @ COEF_N) @ frame
        c_out[i] = ca[i] + (feat @ COEF_C) @ frame
    return n_out.astype(np.float32), c_out.astype(np.float32)

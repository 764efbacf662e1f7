"""3Di structural alphabet encoder.

Geometry -> 10 features -> 3-layer MLP -> nearest of 20 centroids.
Faithful re-derivation of the reference pipeline
(reference: lib/3di/structureto3di.cpp:49-255, structureto3di.h:9-39):

  1. approximate missing C-beta from backbone tetrahedral geometry
  2. replace C-beta with a *virtual interaction center*: rotate CB around the
     CA-N axis system by alpha=270 deg, dihedral beta=0, distance factor d=2
  3. per residue pick the nearest other residue by virtual-center distance
  4. 10 features per (i, partner) pair: 7 unit-vector dot products of CA chain
     directions, CA distance, clipped and log signed sequence offset
  5. tiny MLP (10->10 relu ->10 relu ->2 linear, float32) to a 2-D embedding
  6. snap to the nearest of 20 fixed centroids; invalid residues -> state 2 'D'

Geometry runs in float64 (the reference uses double), the MLP in float32
(kerasify runs in float32), discretization in float64 — matching the
reference's precision boundaries exactly (structureto3di.cpp:217-231).

This module is pure numpy: the encoder is ingest-time work dominated by file
parsing; chains are short (<= ~10k residues) and the O(n^2) partner search is
vectorized.
"""
from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

DISTANCE_ALPHA_BETA = 1.5336
VIRT_ALPHA, VIRT_BETA, VIRT_D = 270.0, 0.0, 2.0
INVALID_STATE = 2  # coil
FEATURE_CNT = 10

CENTROIDS = np.array(
    [
        [-1.0729, -0.3600], [-0.1356, -1.8914], [0.4948, -0.4205], [-0.9874, 0.8128],
        [-1.6621, -0.4259], [2.1394, 0.0486], [1.5558, -0.1503], [2.9179, 1.1437],
        [-2.8814, 0.9956], [-1.1400, -2.0068], [3.2025, 1.7356], [1.7769, -1.3037],
        [0.6901, -1.2554], [-1.1061, -1.3397], [2.1495, -0.8030], [2.3060, -1.4988],
        [2.5522, 0.6046], [0.7786, -2.1660], [-2.3030, 0.3813], [1.0290, 0.8772],
    ],
    dtype=np.float64,
)

# 3Di states index the same alphabet as the substitution matrix rows
STATE_TO_CHAR = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)


class _MLP:
    def __init__(self, npz_path):
        z = np.load(npz_path)
        self.n = int(z["n_layers"])
        self.weights = [(z[f"w{i}"], z[f"b{i}"], str(z[f"act{i}"])) for i in range(self.n)]

    def __call__(self, x32: np.ndarray) -> np.ndarray:
        h = x32.astype(np.float32)
        for w, b, act in self.weights:
            h = h @ w + b
            if act == "relu":
                h = np.maximum(h, np.float32(0))
            elif act != "linear":
                raise NotImplementedError(act)
        return h


_encoder_mlp = None


def encoder_mlp() -> _MLP:
    global _encoder_mlp
    if _encoder_mlp is None:
        _encoder_mlp = _MLP(os.path.join(_DATA, "encoder_3di.npz"))
    return _encoder_mlp


def _norm(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def approx_cbeta(ca, n, c):
    """Tetrahedral C-beta approximation (structureto3di.cpp:49-67)."""
    v1 = _norm(c - ca)
    v2 = _norm(n - ca)
    b1 = v2 + v1 / 3.0
    b2 = np.cross(v1, b1)
    u1 = _norm(b1)
    u2 = _norm(b2)
    v4 = (-1.0 / 3.0) * v1 + np.sqrt(8.0) / 3.0 * (-0.5 * u1 - (np.sqrt(3.0) / 2.0) * u2)
    return ca + DISTANCE_ALPHA_BETA * v4


def virtual_center(ca, cb, n, alpha=VIRT_ALPHA, beta=VIRT_BETA, d=VIRT_D):
    """Two Rodrigues rotations of CB about CA (structureto3di.cpp:73-99)."""
    alpha = np.deg2rad(alpha)
    beta = np.deg2rad(beta)
    v = cb - ca
    a = cb - ca
    b = n - ca
    k = _norm(np.cross(a, b))
    v = (
        v * np.cos(alpha)
        + np.cross(k, v) * np.sin(alpha)
        + k * (np.sum(k * v, axis=-1, keepdims=True)) * (1.0 - np.cos(alpha))
    )
    k = _norm(n - ca)
    v = (
        v * np.cos(beta)
        + np.cross(k, v) * np.sin(beta)
        + k * (np.sum(k * v, axis=-1, keepdims=True)) * (1.0 - np.cos(beta))
    )
    return ca + v * d


def encode_chain(ca, n, c, cb, return_features: bool = False):
    """Encode one chain to 3Di states.

    Args:
      ca, n, c, cb: float64 [L, 3]; missing atoms are NaN (whole-row NaN for a
        missing CB triggers the tetrahedral approximation, NaN in CA/N/C marks
        the residue invalid).
      return_features: also return the 10 raw per-residue features
        (zeros where invalid) — the structureto3didescriptor debug column
        (structureto3didescriptor.cpp:137-155).
    Returns:
      states: int8 [L] in [0, 20); invalid residues get INVALID_STATE.
      (states, features [L, 10] float64) when return_features.
    """
    ca = np.asarray(ca, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    cb = np.asarray(cb, dtype=np.float64)
    L = ca.shape[0]
    states = np.full(L, INVALID_STATE, dtype=np.int8)
    full_feats = np.zeros((L, 10), dtype=np.float64)
    if L < 3:
        return (states, full_feats) if return_features else states

    # step 1+2: virtual centers (replaceCBWithVirtualCenter)
    cb = cb.copy()
    missing_cb = np.isnan(cb[:, 0])
    if missing_cb.any():
        cb[missing_cb] = approx_cbeta(ca[missing_cb], n[missing_cb], c[missing_cb])
    vc = virtual_center(ca, cb, n)

    # residue validity: CA/N/C present (createResidueMask)
    mask = ~(np.isnan(ca[:, 0]) | np.isnan(n[:, 0]) | np.isnan(c[:, 0]))

    # step 3: nearest-neighbour partner among interior valid residues
    # (findResiduePartners: i, j in [1, L-2], j != i, valid[j]).
    partner = np.full(L, -1, dtype=np.int64)
    interior = np.zeros(L, dtype=bool)
    interior[1 : L - 1] = True
    cand = interior & mask
    if cand.any():
        # chunked over rows: the full [L, L] distance matrix would be
        # O(L^2) memory (the reference's maxSeqLen is 65535 — that would be
        # tens of GB); 512-row blocks keep it a few MB at identical results
        blk = 512
        has = np.zeros(L - 2, dtype=bool)
        amin = np.zeros(L - 2, dtype=np.int64)
        for r0 in range(1, L - 1, blk):
            r1 = min(r0 + blk, L - 1)
            d2 = np.sum((vc[r0:r1, None, :] - vc[None, :, :]) ** 2, axis=-1)
            d2[:, ~cand] = np.inf
            d2[np.arange(r1 - r0), np.arange(r0, r1)] = np.inf  # j != i
            # NaN virtual centers (invalid i) propagate NaN distances; the
            # reference compares with `<` so NaN never wins — treat as inf.
            d2 = np.where(np.isnan(d2), np.inf, d2)
            has[r0 - 1:r1 - 1] = d2.min(axis=1) < np.inf
            amin[r0 - 1:r1 - 1] = d2.argmin(axis=1)
        partner[1 : L - 1] = np.where(has, amin, -1)
        mask[1 : L - 1] &= has

    # step 4: features where the 6 flanking residues are all valid
    # (calcConformationDescriptors); maskCopy is the mask *after* the partner
    # update above, matching the reference call order.
    mask_copy = mask.copy()
    feat_ok = np.zeros(L, dtype=bool)
    idx = np.arange(1, L - 1)
    j = partner[idx]
    safe_j = np.clip(j, 1, L - 2)
    ok = (
        mask_copy[idx - 1] & mask_copy[idx] & mask_copy[idx + 1]
        & (j >= 0)
        & mask_copy[safe_j - 1] & mask_copy[safe_j] & mask_copy[safe_j + 1]
    )
    feat_ok[idx] = ok
    mask[idx] &= ok
    mask[0] = False
    mask[L - 1] = False

    if not mask.any():
        return (states, full_feats) if return_features else states

    ii = np.nonzero(mask)[0]
    jj = partner[ii]
    u1 = _norm(ca[ii] - ca[ii - 1])
    u2 = _norm(ca[ii + 1] - ca[ii])
    u3 = _norm(ca[jj] - ca[jj - 1])
    u4 = _norm(ca[jj + 1] - ca[jj])
    u5 = _norm(ca[jj] - ca[ii])
    dots = lambda a, b: np.sum(a * b, axis=-1)
    delta = (jj - ii).astype(np.float64)
    feats = np.stack(
        [
            dots(u1, u2), dots(u3, u4), dots(u1, u5), dots(u3, u5),
            dots(u1, u4), dots(u2, u3), dots(u1, u3),
            np.linalg.norm(ca[ii] - ca[jj], axis=-1),
            np.copysign(np.minimum(np.abs(delta), 4.0), delta),
            np.copysign(np.log(np.abs(delta) + 1.0), delta),
        ],
        axis=1,
    )

    # step 5: MLP in float32, back to float64 (encodeFeatures)
    emb = encoder_mlp()(feats.astype(np.float32)).astype(np.float64)

    # step 6: nearest centroid (discretizeEmbeddings)
    d2c = np.sum((emb[:, None, :] - CENTROIDS[None, :, :]) ** 2, axis=-1)
    states[ii] = d2c.argmin(axis=1).astype(np.int8)
    if return_features:
        full_feats[ii] = feats
        return states, full_feats
    return states


def states_to_string(states) -> str:
    return STATE_TO_CHAR[np.asarray(states)].tobytes().decode("ascii")


# alternative alphabet: discretized partner sequence distance
# (reference: lib/3di/structureto3diseqdist.{h,cpp})
SEQDIST_CENTROIDS = np.array(
    [-284, -147, -83, -52, -33, -21, -13, -7, -4, -3, -1,
     1, 3, 7, 13, 24, 40, 68, 123, 250], dtype=np.int64)


def encode_chain_seqdist(ca, n, c, cb):
    """3Di seq-dist variant: same virtual-center partner search, state =
    nearest centroid to the signed sequence offset partner-i
    (StructureTo3diSeqDist::structure2states)."""
    ca = np.asarray(ca, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    cb = np.asarray(cb, dtype=np.float64).copy()
    L = ca.shape[0]
    states = np.full(L, INVALID_STATE, dtype=np.int8)
    if L < 3:
        return states
    missing_cb = np.isnan(cb[:, 0])
    if missing_cb.any():
        cb[missing_cb] = approx_cbeta(ca[missing_cb], n[missing_cb], c[missing_cb])
    vc = virtual_center(ca, cb, n)
    mask = ~(np.isnan(ca[:, 0]) | np.isnan(n[:, 0]) | np.isnan(c[:, 0]))
    partner = np.full(L, -1, dtype=np.int64)
    interior = np.zeros(L, dtype=bool)
    interior[1:L - 1] = True
    cand = interior & mask
    if cand.any():
        d2 = np.sum((vc[:, None, :] - vc[None, :, :]) ** 2, axis=-1)
        d2[:, ~cand] = np.inf
        np.fill_diagonal(d2, np.inf)
        d2 = np.where(np.isnan(d2), np.inf, d2)
        has = d2[1:L - 1].min(axis=1) < np.inf
        partner[1:L - 1] = np.where(has, d2[1:L - 1].argmin(axis=1), -1)
        mask[1:L - 1] &= has
    # nearest centroid to (partner - i); first-wins ties via argmin on abs
    seq_dist = partner - np.arange(L)
    dist = np.abs(SEQDIST_CENTROIDS[None, :] - seq_dist[:, None])
    nearest = dist.argmin(axis=1).astype(np.int8)
    states = np.where(mask, nearest, INVALID_STATE).astype(np.int8)
    return states

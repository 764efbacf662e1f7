"""C-alpha LDDT of a fixed alignment.

Re-derivation of the reference LDDT (reference: src/commons/LDDT.cpp:87-215):
for each pair of aligned query residues closer than 15 A in the query, score
0.25 * #(|d_query - d_target| < {0.5, 1, 2, 4}) and credit both residues;
normalize each aligned column by that query residue's total <15 A neighbor
count over ALL query residues (aligned or not); average over M columns
(columns with no neighbors are excluded, LDDT.h LDDTScoreResult NaN skip).

The reference uses a 3-D grid hash to prune the O(L^2) neighbor search — a CPU
optimization; here the masked pairwise form is a few vectorized ops.
`lddt_chunk` / `batched_lddt_device` are the batched form of the device gate
fleet (`ops/gates_device.py`) in plain PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def backtrace_indices(backtrace: str, q_start: int, t_start: int):
    """Vectorized M-column index extraction from a backtrace string:
    (q_idx, t_idx) of aligned pairs. q advances on M/I, t on M/D."""
    arr = np.frombuffer(backtrace.encode("ascii"), dtype=np.uint8)
    qstep = arr != ord("D")
    tstep = arr != ord("I")
    qpos = q_start + np.cumsum(qstep) - qstep
    tpos = t_start + np.cumsum(tstep) - tstep
    m = arr == ord("M")
    return qpos[m], tpos[m]


@dataclass
class LDDTResult:
    avg_lddt: float
    per_col: np.ndarray  # per aligned (M) column scores
    score_length: int


def lddt_query_context(q_ca: np.ndarray):
    """Per-query precomputation shared across all of its hits: the query
    coords + per-residue <15 A neighbor degree (LDDT.cpp:100-116).
    Rebuilding this per hit dominated the align stage. Degree is computed
    in row blocks — a full [L, L] matrix at the reference's 65535-residue
    maxSeqLen would be tens of GB."""
    q = np.asarray(q_ca, dtype=np.float32)
    L = len(q)
    from .. import native
    deg = native.lddt_degree(q)
    if deg is not None:
        # reference-exact float distance + cutoff (LDDT.cpp:100-116);
        # the squared-distance numpy fallback below can flip borderline
        # ~15.000A pairs by a float ulp
        return q, deg
    degree = np.zeros(L, dtype=np.float32)
    blk = 1024
    for r0 in range(0, L, blk):
        d2 = ((q[r0:r0 + blk, None, :] - q[None, :, :]) ** 2).sum(-1)
        close = d2 < 15.0 * 15.0
        close[np.arange(min(blk, L - r0)), np.arange(r0, min(r0 + blk, L))] = False
        degree[r0:r0 + blk] = close.sum(axis=1)
    return q, degree


def compute_lddt(q_ca: np.ndarray, t_ca: np.ndarray,
                 q_start: int, t_start: int, backtrace: str,
                 q_ctx=None) -> LDDTResult:
    q_idx, t_idx = backtrace_indices(backtrace, q_start, t_start)
    n = len(q_idx)
    if n == 0:
        return LDDTResult(0.0, np.zeros(0, dtype=np.float32), 0)

    ta = np.asarray(t_ca, dtype=np.float32)[t_idx]

    if q_ctx is None:
        q_ctx = lddt_query_context(q_ca)
    q32, degree = q_ctx

    from .. import native
    qa32 = q32[q_idx]
    res = native.lddt_aligned(qa32, ta, degree[q_idx])
    if res is not None:
        avg, per_col, score_len = res
        # columns with zero degree are NaN-skipped in the reference;
        # per_col here already holds 0 for them like the nan_to_num below
        return LDDTResult(avg, per_col, score_len)

    # aligned-aligned pair scores (fallback path; aligned subset only)
    dq = np.sqrt(((qa32[:, None, :] - qa32[None, :, :]) ** 2).sum(-1))
    close = dq < 15.0
    np.fill_diagonal(close, False)
    dt = np.sqrt(((ta[:, None, :] - ta[None, :, :]) ** 2).sum(-1))
    dl = np.abs(dq - dt)
    pair = 0.25 * ((dl < 0.5).astype(np.float32) + (dl < 1.0) + (dl < 2.0) + (dl < 4.0))
    pair = np.where(close, pair, 0.0)
    col_sum = pair.sum(axis=1)

    deg = degree[q_idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        per_col = np.where(deg > 0, col_sum / np.maximum(deg, 1), np.nan).astype(np.float32)
    valid = ~np.isnan(per_col)
    score_length = int(valid.sum())
    avg = float(per_col[valid].sum() / score_length) if score_length else 0.0
    return LDDTResult(avg, np.nan_to_num(per_col), score_length)


# bytes one [chunk, M, M] float32 temporary of the batched form may take
LDDT_TEMP_BYTES = 1 << 27


def lddt_chunk_for(m_pad: int) -> int:
    """Power-of-two number of pairs a chunk of the batched LDDT holds,
    bounding each [chunk, m_pad, m_pad] float32 temporary to
    LDDT_TEMP_BYTES."""
    c = LDDT_TEMP_BYTES // (4 * m_pad * m_pad)
    return 1 << max(3, min(12, c.bit_length() - 1))


def _pair_distances(x: torch.Tensor) -> torch.Tensor:
    """[P, M, M] distances of [P, M, 3] points from direct per-pair
    differences, one coordinate at a time (no [P, M, M, 3] cube). A Gram
    product (n_i + n_j - 2 x_i.x_j) would cancel by |x|^2 / d^2 at d ~ 1 A,
    about 1e-3 A, which biases |dq - dt| up near the 0.5 / 1 / 2 / 4
    thresholds: a one-sided LDDT deficit. Direct differences keep the error
    at d * eps."""
    d2 = None
    for a in range(3):
        c = x[:, :, a]
        diff = c[:, :, None] - c[:, None, :]
        d2 = diff.square_() if d2 is None else d2.addcmul_(diff, diff)
    return d2.sqrt_()


def lddt_chunk(q: torch.Tensor, t: torch.Tensor, dg: torch.Tensor,
               ml: torch.Tensor):
    """LDDT of one chunk of pairs: q, t [P, M, 3] padded aligned coords, dg
    [P, M] per-column query degrees, ml int [P] true column counts. Returns
    (avg float32 [P], number of scored columns float32 [P])."""
    M = q.shape[1]
    idx = torch.arange(M, device=q.device)
    valid = idx[None, :] < ml[:, None]                          # [P, M]
    dq = _pair_distances(q)
    close = (dq < 15.0) & valid[:, :, None] & valid[:, None, :] \
        & (idx[:, None] != idx[None, :])
    dl = dq.sub_(_pair_distances(t)).abs_()
    pair = 0.25 * ((dl < 0.5).to(torch.float32) + (dl < 1.0) + (dl < 2.0)
                   + (dl < 4.0))
    col = pair.mul_(close).sum(2)
    ok = (dg > 0) & valid
    per_col = torch.where(ok, col / dg.clamp_min(1.0), 0.0)
    n_ok = ok.sum(1)
    avg = torch.where(n_ok > 0, per_col.sum(1) / n_ok.clamp_min(1), 0.0)
    return avg.to(torch.float32), n_ok.to(torch.float32)


def batched_lddt_device(qa: np.ndarray, ta: np.ndarray, deg: np.ndarray,
                        m_len: np.ndarray, device: torch.device,
                        chunk: int = 0):
    """Batched C-alpha LDDT on `device`: [P, M_pad, 3] padded aligned
    coords, [P, M_pad] per-column query degrees, [P] true column counts.
    Returns (avg [P] float32, score_len [P] int32). Scores match
    compute_lddt to float32 accuracy."""
    device = torch.device(device)
    P, M, _ = qa.shape
    chunk = chunk or lddt_chunk_for(M)
    q = torch.from_numpy(np.asarray(qa, np.float32)).to(device)
    t = torch.from_numpy(np.asarray(ta, np.float32)).to(device)
    dg = torch.from_numpy(np.asarray(deg, np.float32)).to(device)
    ml = torch.from_numpy(np.asarray(m_len, np.int32)).to(device)
    if P == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    parts = [lddt_chunk(q[c: c + chunk], t[c: c + chunk], dg[c: c + chunk],
                        ml[c: c + chunk]) for c in range(0, P, chunk)]
    avg = torch.cat([a for a, _ in parts]).cpu().numpy()
    n_ok = torch.cat([n for _, n in parts]).cpu().numpy()
    return avg, n_ok.astype(np.int32)

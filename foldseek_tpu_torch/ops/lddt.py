"""C-alpha LDDT of a fixed alignment.

Re-derivation of the reference LDDT (reference: src/commons/LDDT.cpp:87-215):
for each pair of aligned query residues closer than 15 A in the query, score
0.25 * #(|d_query - d_target| < {0.5, 1, 2, 4}) and credit both residues;
normalize each aligned column by that query residue's total <15 A neighbor
count over ALL query residues (aligned or not); average over M columns
(columns with no neighbors are excluded, LDDT.h LDDTScoreResult NaN skip).

The reference uses a 3-D grid hash to prune the O(L^2) neighbor search — a CPU
optimization; here the masked pairwise form is a few vectorized ops. The
batched device form (`batched_lddt_device`) belongs to the device gate fleet,
which is not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

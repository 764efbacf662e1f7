"""Plain PyTorch dynamic programs of the reference: the ungapped diagonal
score of one query against every target of a DB, and affine Smith-Waterman
scores with end positions, against every target (3Di only) or against a
list of targets (3Di + AA). No kernel of the program: tensor operations
only, one query row a step, every target of a length bucket in parallel.

Recurrences, with rows i over the query and columns j over the target:
  ungapped: h[i][j] = min(max(h[i-1][j-1] + s(i, j), 0), cap), the best h
    over the matrix (a running byte score that saturates, MMseqs2's
    ungapped_alignment);
  Smith-Waterman (Gotoh, gap of length l costs open + (l - 1) * extend,
    with the SSW/MMseqs2 lazy-F rule that a gap along the target opens only
    from a cell's value before the gap along the query is applied):
      h0[i][j]  = max(H[i-1][j-1] + s(i, j), 0)
      E[i][j]   = max_k<j (h0[i][k] - open - (j-1-k) * extend)
      hE[i][j]  = max(h0[i][j], E[i][j])
      F[i][j]   = max(F[i-1][j] - extend, hE[i-1][j] - open)
      H[i][j]   = max(hE[i][j], F[i][j])
    score = max H; target end = the first column whose maximum reaches it;
    query end = the first row reaching that column's maximum.
`sat` (the control) clamps every H at that value, as 8-bit saturating
arithmetic would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .scoring import GAP_EXTEND, GAP_OPEN, M3DI_PREF

PAD = 20                     # pad letter of `sw_pairs`: the X column
PAD_SCORE = -1000            # its score there
TABLE_PAD = 21               # pad letter of the DB tables: a column of
TABLE_PAD_SCORE = -128       # -128, so that a pad cell, at the end of its
                             # target, stays below every real cell before it
NEG = -(1 << 28)


def length_buckets(lengths: np.ndarray, growth: float = 1.25,
                   base: int = 64) -> List[np.ndarray]:
    """Entry indices grouped by padded length (multiples of 32, each bucket
    about `growth` times the last), shortest first."""
    order = np.argsort(lengths, kind="stable")
    sl = lengths[order]
    out, start, edge = [], 0, base
    while start < len(sl):
        while edge < sl[start]:
            edge = int(-(-edge * growth // 32) * 32)
        stop = int(np.searchsorted(sl, edge, side="right"))
        out.append(order[start:stop])
        start = stop
    return out


@dataclass
class Bucket:
    idx: np.ndarray          # DB entry indices
    table: torch.Tensor      # int8 [21, n, Lt]: M3DI_PREF[a][letter]
    valid: torch.Tensor      # bool [n, Lt]: column j < length


class TargetTables:
    """The DB's 3Di letters in length buckets on `device`, with the score of
    every (query letter, target cell) under the prefilter's 3Di matrix
    (int8, 21 x the padded residues): a query row's scores are one slice
    plus its bias."""

    def __init__(self, ss: np.ndarray, offsets: np.ndarray, device):
        dev = torch.device(device)
        lengths = np.diff(offsets)
        ss_dev = torch.from_numpy(np.asarray(ss, dtype=np.int8)).to(dev)
        mat = torch.tensor(np.concatenate(
            [M3DI_PREF, np.full((21, 1), TABLE_PAD_SCORE)], axis=1),
            dtype=torch.int8, device=dev)
        self.buckets: List[Bucket] = []
        for idx in length_buckets(lengths):
            L = lengths[idx]
            lt = int(L.max())
            lt = -(-lt // 32) * 32
            n = len(idx)
            L_dev = torch.from_numpy(L.astype(np.int64)).to(dev)
            start = torch.from_numpy(offsets[idx].astype(np.int64)).to(dev)
            col = torch.arange(lt, device=dev)
            valid = col[None, :] < L_dev[:, None]
            src = (start[:, None] + col[None, :]).clamp_max(len(ss) - 1)
            letters = torch.where(valid, ss_dev[src].long(),
                                  torch.full_like(src, TABLE_PAD))
            table = mat[:, letters]                     # [21, n, lt] int8
            self.buckets.append(Bucket(idx=idx, table=table, valid=valid))
        self.n = len(lengths)


def ungapped_all(prof: np.ndarray, cap: int, tables: TargetTables,
                 ss_q: np.ndarray) -> np.ndarray:
    """int64 [n] ungapped scores of one query (profile = table row of its
    letter + bias) against every target."""
    bias = (prof - M3DI_PREF[:, np.asarray(ss_q, dtype=np.int64)])[0]
    out = np.zeros(tables.n, dtype=np.int64)
    for b in tables.buckets:
        dev = b.table.device
        n, lt = b.valid.shape
        h = torch.zeros((n, lt), dtype=torch.int16, device=dev)
        hn = torch.empty_like(h)
        best = torch.zeros(n, dtype=torch.int16, device=dev)
        for i, a in enumerate(np.asarray(ss_q, dtype=np.int64)):
            row = b.table[int(a)]
            hn[:, 0] = row[:, 0]
            torch.add(h[:, :-1], row[:, 1:], out=hn[:, 1:])
            hn.add_(int(bias[i])).clamp_(0, cap)
            best = torch.maximum(best, hn.amax(dim=1))
            h, hn = hn, h
        out[b.idx] = best.cpu().numpy()
    return out


def _sw_rows(score_row, n_rows: int, shape, dev, sat: Optional[int]):
    """The Smith-Waterman recurrence over rows; `score_row(i, out)` writes
    the int32 [..., Lt] cell scores of query row i into `out`. Returns
    (colmax, colrow): each column's best H and the first row reaching it."""
    go, ge = GAP_OPEN, GAP_EXTEND
    lt = shape[-1]
    jge = torch.arange(lt, device=dev, dtype=torch.int32) * ge
    e_off = jge[1:] - ge + go
    i32 = dict(dtype=torch.int32, device=dev)
    H = torch.zeros(shape, **i32)
    hE = torch.zeros(shape, **i32)
    F = torch.full(shape, NEG, **i32)
    s = torch.empty(shape, **i32)
    h0 = torch.empty(shape, **i32)
    E = torch.full(shape, NEG, **i32)
    tmp = torch.empty(shape, **i32)
    colmax = torch.zeros(shape, **i32)
    colrow = torch.zeros(shape, dtype=torch.int16, device=dev)
    up = torch.empty(shape, dtype=torch.bool, device=dev)
    for i in range(n_rows):
        score_row(i, s)
        h0[..., 0] = s[..., 0]
        torch.add(H[..., :-1], s[..., 1:], out=h0[..., 1:])
        h0.clamp_(min=0)
        torch.add(h0, jge, out=tmp)
        cm = torch.cummax(tmp, dim=-1).values
        torch.sub(cm[..., :-1], e_off, out=E[..., 1:])
        if i:
            F.sub_(ge)
            torch.sub(hE, go, out=tmp)
            torch.maximum(F, tmp, out=F)
        torch.maximum(h0, E, out=hE)
        torch.maximum(hE, F, out=H)
        if sat is not None:
            H.clamp_(max=sat)
        torch.gt(H, colmax, out=up)
        torch.maximum(colmax, H, out=colmax)
        colrow.masked_fill_(up, i)
    return colmax, colrow.to(torch.int32)


def _ends(colmax, colrow, valid, q_len: int):
    """(score, q_end, t_end) from the column maxima over real columns."""
    colmax = torch.where(valid, colmax, -1)
    best = colmax.amax(dim=-1)
    t_end = (colmax == best[..., None]).to(torch.int8).argmax(dim=-1)
    q_end = torch.gather(colrow, -1, t_end[..., None])[..., 0]
    none = best <= 0
    t_end = torch.where(none, 0, t_end)
    q_end = torch.where(none, q_len - 1, q_end)
    return best, q_end, t_end


def sw_all(prof: np.ndarray, ss_q: np.ndarray, tables: TargetTables,
           sat: Optional[int] = None):
    """3Di-only SW of one query (prefilter profile) against every target:
    int64 [n] score, q_end, t_end."""
    bias = (prof - M3DI_PREF[:, np.asarray(ss_q, dtype=np.int64)])[0]
    letters = np.asarray(ss_q, dtype=np.int64)
    out = np.zeros((3, tables.n), dtype=np.int64)
    for b in tables.buckets:
        dev = b.table.device

        def row(i, out):
            out.copy_(b.table[int(letters[i])])
            out.add_(int(bias[i]))
        cm, cr = _sw_rows(row, len(letters), b.valid.shape, dev, sat)
        res = _ends(cm, cr, b.valid, len(letters))
        out[:, b.idx] = torch.stack(res).cpu().numpy()
    return out[0], out[1], out[2]


def sw_pairs(profs, t_aa: List[np.ndarray], t_ss: List[np.ndarray], device,
             sat: Optional[int] = None):
    """3Di+AA SW of several profiles of one query length against the same
    targets: `profs` [(prof_aa, prof_ss)] int [21, Lq] each. Returns int64
    [len(profs), 3, len(t_aa)]: score, q_end, t_end."""
    dev = torch.device(device)
    n = len(t_aa)
    out = np.zeros((len(profs), 3, n), dtype=np.int64)
    if n == 0:
        return out
    lens = np.array([len(t) for t in t_aa])
    lq = profs[0][0].shape[1]
    for idx in length_buckets(lens):
        lt = -(-int(lens[idx].max()) // 32) * 32
        A = np.full((len(idx), lt), PAD, dtype=np.int64)
        S = np.full((len(idx), lt), PAD, dtype=np.int64)
        for r, k in enumerate(idx):
            A[r, :lens[k]] = t_aa[k]
            S[r, :lens[k]] = t_ss[k]
        A, S = torch.from_numpy(A).to(dev), torch.from_numpy(S).to(dev)
        valid = torch.arange(lt, device=dev)[None, :] < torch.from_numpy(
            lens[idx]).to(dev)[:, None]
        pad = torch.where(valid, 0, PAD_SCORE).to(torch.int32)
        pa = torch.tensor(np.stack([p[0] for p in profs]), dtype=torch.int32,
                          device=dev)                  # [m, 21, Lq]
        ps = torch.tensor(np.stack([p[1] for p in profs]), dtype=torch.int32,
                          device=dev)

        def row(i, out):
            torch.add(pa[:, :, i][:, A], ps[:, :, i][:, S], out=out)
            out.add_(pad)

        shape = (len(profs), len(idx), lt)
        cm, cr = _sw_rows(row, lq, shape, dev, sat)
        res = _ends(cm, cr, valid.expand(shape), lq)
        out[:, :, idx] = torch.stack(res, dim=1).cpu().numpy()
    return out

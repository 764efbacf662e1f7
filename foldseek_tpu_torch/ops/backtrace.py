"""Alignment start-position recovery + banded traceback (host side).

The device kernel returns only (score, q_end, t_end) — like the reference's
vectorized score pass. Start positions and the cigar are recovered here,
mirroring the reference's two-phase design
(reference: src/commons/StructureSmithWaterman.cpp alignStartPosBacktrace:
reverse Smith-Waterman with early termination for starts :539-676, then
banded_sw with doubling band width for the backtrace :1724-1957).

This runs on the host for the handful of hits that survive the E-value gate;
the heavy all-pairs scoring stays on the device.

Counterpart of `foldseek_tpu/ops/backtrace.py`; the code is unchanged apart
from the imports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .sw import sw_score_endpos_np


@dataclass
class Traceback:
    q_start: int
    t_start: int
    backtrace: str  # M/I/D per column; I consumes query, D consumes target
    identical_aa: int


def find_start_pos(rprof_aa: np.ndarray, rprof_ss: np.ndarray, q_len: int,
                   t_aa: np.ndarray, t_ss: np.ndarray,
                   score: int, q_end: int, t_end: int,
                   gap_open: int = 10, gap_extend: int = 1) -> Tuple[int, int]:
    """Reverse SW over the end-bounded region, stopping at `terminate`=score
    (reference: alignStartPosBacktrace, sw kernels' maxColumn[i]==terminate
    break). Returns (q_start, t_start)."""
    offset = q_len - q_end - 1
    # reversed-query profile restricted to reversed positions [offset, offset+q_end+1)
    pa = rprof_aa[:, offset: offset + q_end + 1]
    ps = rprof_ss[:, offset: offset + q_end + 1]
    best, read, ref = sw_score_endpos_np(
        pa, ps, t_aa[: t_end + 1], t_ss[: t_end + 1],
        gap_open=gap_open, gap_extend=gap_extend,
        terminate=score, reverse_target=True)
    if best != score:
        raise RuntimeError(f"forward/backward SW scores differ: {best} != {score}")
    return q_end - read, ref


def banded_sw(t_aa, t_ss, prof_aa, prof_ss, q_start, q_end, t_start, t_end,
              score: int, gap_open: int = 10, gap_extend: int = 1) -> str:
    """Banded affine DP + traceback over the alignment region, identical
    semantics to the reference's banded_sw (StructureSmithWaterman.cpp:1724):
      * band width |dbLen - qLen| + 1, doubled until the banded max >= score
      * H prefers diagonal on ties, then E over F only when strictly greater
      * out-of-band cells read as 0
    prof_* are the [21, Lq] full-query combined profiles (bias included).
    Returns the M/I/D backtrace string.
    """
    q_lo, q_hi = q_start, q_end + 1
    t_lo, t_hi = t_start, t_end + 1
    qL = q_hi - q_lo
    tL = t_hi - t_lo
    # per-region score lookup: s[i, j] = prof[t_letter[j], q_lo + i]
    sub = (prof_aa[:, q_lo:q_hi][t_aa[t_lo:t_hi]]
           + prof_ss[:, q_lo:q_hi][t_ss[t_lo:t_hi]]).T.astype(np.int64)  # [qL, tL]

    band_width = abs(tL - qL) + 1
    go, ge = gap_open, gap_extend

    while True:
        w = band_width
        width = w * 2 + 3
        width_d = w * 2 + 1
        h_b = np.zeros(width, dtype=np.int64)
        e_b = np.zeros(width, dtype=np.int64)
        h_c = np.zeros(width, dtype=np.int64)
        # direction[i, u, p]: p=0 E-dir, 1 F-dir, 2 H-dir
        direction = np.zeros((qL, width_d, 3), dtype=np.int8)
        max_score = 0

        def set_u(i, j):
            x = i - w
            if x < 0:
                x = 0
            return j - x + 1

        for i in range(qL):
            beg = max(0, i - w)
            end = min(tL - 1, i + w)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            dline = direction[i]
            row_sub = sub[i]
            for j in range(beg, end + 1):
                u = set_u(i, j)
                e_coord = set_u(i - 1, j)
                b_coord = set_u(i, j - 1)
                d_coord = set_u(i - 1, j - 1)
                du = j - max(0, i - w)  # direction column index

                if i == 0:
                    temp1 = -go
                    temp2 = -ge
                else:
                    temp1 = h_b[e_coord] - go
                    temp2 = e_b[e_coord] - ge
                if temp1 > temp2:
                    e_val = temp1
                    dline[du, 0] = 3
                else:
                    e_val = temp2
                    dline[du, 0] = 2
                e_b_u = e_val

                temp1 = h_c[b_coord] - go
                temp2 = f - ge
                if temp1 > temp2:
                    f = temp1
                    dline[du, 1] = 5
                else:
                    f = temp2
                    dline[du, 1] = 4

                e1 = e_b_u if e_b_u > 0 else 0
                f1 = f if f > 0 else 0
                temp1 = e1 if e1 > f1 else f1
                temp2 = h_b[d_coord] + row_sub[j]

                h = temp1 if temp1 > temp2 else temp2
                if h > max_score:
                    max_score = h
                if temp1 <= temp2:
                    dline[du, 2] = 1
                else:
                    dline[du, 2] = dline[du, 0] if e1 > f1 else dline[du, 1]
                e_b[u] = e_b_u
                h_c[u] = h
            u = set_u(i, end)
            h_b[1: u + 1] = h_c[1: u + 1]
        if max_score >= score:
            break
        band_width *= 2

    # traceback (reference :1856-1934); cell (0,0) is always the final M
    i = qL - 1
    j = tL - 1
    ops = []
    state = 2
    while i > 0 or j > 0:
        du = j - max(0, i - band_width)
        d = direction[i, du, 0 if state == 0 else (1 if state == 1 else 2)]
        if d == 1:
            i -= 1
            j -= 1
            state = 2
            ops.append("M")
        elif d == 2:
            i -= 1
            state = 0
            ops.append("I")
        elif d == 3:
            i -= 1
            state = 2
            ops.append("I")
        elif d == 4:
            j -= 1
            state = 1
            ops.append("D")
        elif d == 5:
            j -= 1
            state = 2
            ops.append("D")
        else:
            raise RuntimeError(f"traceback error at ({i},{j}) state {state}")
    ops.append("M")  # the (0,0) cell
    return "".join(reversed(ops))


def recover_alignment(prof, t_aa: np.ndarray, t_ss: np.ndarray,
                      score: int, q_end: int, t_end: int) -> Traceback:
    """Full start + cigar recovery for one hit from the forward QueryProfile.
    The reverse profile for start recovery is the *flipped* forward profile
    (sequence and bias reverse-copied, StructureSmithWaterman.cpp:1703-1706),
    not the recomputed-bias reverse profile used for score correction.

    Runs through the native host library when available (native.py; same
    semantics, ~50x faster per hit), falling back to the numpy paths."""
    from .. import native
    # the flipped profile is per-QUERY state; rebuilding it per hit cost
    # ~0.1 ms x fleet size
    fprof = getattr(prof, "_flipped_cache", None)
    if fprof is None:
        fprof = prof.flipped()
        prof._flipped_cache = fprof
    lib = native.get_lib()
    if lib is not None:
        offset = prof.L - q_end - 1
        res = native.reverse_sw(
            np.ascontiguousarray(fprof.prof_aa[:, offset: offset + q_end + 1]),
            np.ascontiguousarray(fprof.prof_ss[:, offset: offset + q_end + 1]),
            t_aa[: t_end + 1], t_ss[: t_end + 1],
            prof.gap_open, prof.gap_extend, score)
        best, read, ref = res
        if best != score:
            raise RuntimeError(f"forward/backward SW scores differ: {best} != {score}")
        q_start, t_start = q_end - read, ref
        sub = (prof.prof_aa[:, q_start:q_end + 1][t_aa[t_start:t_end + 1]]
               + prof.prof_ss[:, q_start:q_end + 1][t_ss[t_start:t_end + 1]]).T
        bt = native.banded_sw_bt(sub.astype(np.int32), score,
                                 prof.gap_open, prof.gap_extend)
        # vectorized identity count over M columns (a python char loop here
        # was ~13M iterations per 64k-hit fleet)
        from .lddt import backtrace_indices
        q_idx, t_idx = backtrace_indices(bt, q_start, t_start)
        ident = int((np.asarray(prof.q_aa)[q_idx]
                     == np.asarray(t_aa)[t_idx]).sum())
        return Traceback(q_start=q_start, t_start=t_start, backtrace=bt,
                         identical_aa=ident)

    q_start, t_start = find_start_pos(
        fprof.prof_aa, fprof.prof_ss, prof.L, t_aa, t_ss, score, q_end, t_end,
        gap_open=prof.gap_open, gap_extend=prof.gap_extend)
    bt = banded_sw(t_aa, t_ss, prof.prof_aa, prof.prof_ss,
                   q_start, q_end, t_start, t_end, score,
                   gap_open=prof.gap_open, gap_extend=prof.gap_extend)
    # identical AA count over M columns (computerBacktrace, :746-773)
    qi, ti = q_start, t_start
    ident = 0
    for op in bt:
        if op == "M":
            ident += int(prof.q_aa[qi] == t_aa[ti])
            qi += 1
            ti += 1
        elif op == "I":
            qi += 1
        else:
            ti += 1
    return Traceback(q_start=q_start, t_start=t_start, backtrace=bt, identical_aa=ident)

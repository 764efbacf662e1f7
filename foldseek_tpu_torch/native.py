"""ctypes bindings for the native host library (native/foldseek_host.cpp).

The library is compiled on first use with g++ -O3 -march=native from the
sources in the repository's top-level `native/` directory into this
package's own build directory (`foldseek_tpu_torch/build/`); every entry
point has a pure-Python fallback in ops/, so the package works without a
compiler (at reduced host-stage speed).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .utils.log import logger

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "foldseek_host.cpp")
_SO = os.path.join(_PKG_DIR, "build", "libfoldseek_host.so")

_lib = None
_lock = threading.Lock()
_tried = False


def _build() -> bool:
    # build beside the target and rename: a second process that starts
    # meanwhile never loads a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("native build failed (%s); using Python fallbacks", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_SRC):
            return None
        if (not os.path.isfile(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            logger.warning("native load failed (%s); using Python fallbacks", e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.reverse_sw.argtypes = [i32p, i32p, ctypes.c_int, i8p, i8p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, i64p]
        lib.reverse_sw.restype = ctypes.c_int
        lib.banded_sw_bt.argtypes = [i32p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_char_p]
        lib.banded_sw_bt.restype = ctypes.c_int
        lib.tm_score_aligned.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int, dp]
        lib.tm_score_aligned.restype = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        lib.tm_search8.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_int, dp]
        lib.tm_search8.restype = ctypes.c_int
        lib.tm_search8f.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_int, dp]
        lib.tm_search8f.restype = ctypes.c_int
        lib.score_fast.argtypes = [fp, fp, ctypes.c_int, ctypes.c_double,
                                   ctypes.c_double, dp]
        lib.score_fast.restype = ctypes.c_int
        lib.dp_iter_c.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, i64p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double,
                                  dp, i64p, i32p]
        lib.dp_iter_c.restype = ctypes.c_int
        lib.score_fast_batch.argtypes = [fp, fp, ctypes.c_int, i64p,
                                         ctypes.c_int, ctypes.c_double,
                                         ctypes.c_double, dp]
        lib.score_fast_batch.restype = ctypes.c_int
        lib.nw_xyz_c.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int,
                                 dp, dp, ctypes.c_double, ctypes.c_float,
                                 i8p, i8p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_long)]
        lib.nw_xyz_c.restype = ctypes.c_int
        lib.nw_gotoh_f32.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.POINTER(ctypes.c_long)]
        lib.nw_gotoh_f32.restype = ctypes.c_int
        lib.lddt_aligned.argtypes = [fp, fp, fp, ctypes.c_int, dp, fp]
        lib.lddt_aligned.restype = ctypes.c_int
        if hasattr(lib, "tm_score_aligned_ref"):
            lib.tm_score_aligned_ref.argtypes = [fp, fp, ctypes.c_int,
                                                 ctypes.c_int, dp]
            lib.tm_score_aligned_ref.restype = ctypes.c_int
        if hasattr(lib, "lddt_aligned_ref"):
            lib.lddt_aligned_ref.argtypes = [fp, fp, fp, ctypes.c_int, dp, fp]
            lib.lddt_aligned_ref.restype = ctypes.c_int
        if hasattr(lib, "lddt_degree_ref"):
            lib.lddt_degree_ref.argtypes = [fp, ctypes.c_int, fp]
            lib.lddt_degree_ref.restype = ctypes.c_int
        lib.lol_block.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int,
                                  i64p, i64p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, fp, fp, fp, ctypes.c_float,
                                  fp, i64p]
        lib.lol_block.restype = ctypes.c_int
        lib.fwbw_posterior_c.argtypes = [dp, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_double, ctypes.c_double,
                                         ctypes.c_double, dp, dp]
        lib.fwbw_posterior_c.restype = ctypes.c_int
        lib.dist_matrix_c.argtypes = [fp, ctypes.c_int, ctypes.c_int, fp]
        lib.dist_matrix_c.restype = ctypes.c_int
        lib.lol_init_query_vec.argtypes = [fp, ctypes.c_int, fp, fp, fp,
                                           fp, ctypes.c_float, dp]
        lib.lol_init_query_vec.restype = ctypes.c_int
        lib.lolalign_c.argtypes = [fp, ctypes.c_int, ctypes.c_int, fp, fp,
                                   ctypes.c_int, ctypes.c_int,
                                   fp, fp, fp, ctypes.c_float,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_int,
                                   ctypes.c_int, i8p, i8p, i32p]
        lib.lolalign_c.restype = ctypes.c_int
        lib.lol_anchor_score_c.argtypes = [i8p, i8p, ctypes.c_int,
                                           ctypes.c_int, fp, fp, fp, fp, fp,
                                           fp, ctypes.c_float, i64p, i64p,
                                           i32p, dp]
        lib.lol_anchor_score_c.restype = ctypes.c_int
        lib.fwbw_forward_m.argtypes = [dp, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ctypes.c_double, dp]
        lib.fwbw_forward_m.restype = ctypes.c_int
        lib.batch_recover.argtypes = [
            i32p, i32p, i32p, i32p, i8p, ctypes.c_int, i8p, i8p,
            i64p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p, ctypes.c_char_p, i64p, i32p]
        lib.batch_recover.restype = ctypes.c_int
        lib.batch_gates.argtypes = [
            fp, ctypes.c_int, fp, fp, i64p, i32p, i32p,
            ctypes.c_char_p, i64p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            dp, dp, dp, dp, dp]
        lib.batch_gates.restype = ctypes.c_int
        lib.diag_score_batch.argtypes = [i32p, ctypes.c_int, i8p, i64p,
                                         i32p, i64p, i32p, ctypes.c_int,
                                         i32p]
        lib.diag_score_batch.restype = ctypes.c_int
        lib.double_diag_detect.argtypes = [i64p, i64p, ctypes.c_int64,
                                           ctypes.c_int64, i64p, i64p]
        lib.double_diag_detect.restype = ctypes.c_int
        lib.posting_candidates.argtypes = [
            i64p, ctypes.c_int64, i64p, i64p, i64p,
            i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int, i8p, i64p, i32p,
            i64p, i32p, i64p]
        lib.posting_candidates.restype = ctypes.c_int
        lib.tmalign_c.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int,
                                  ctypes.c_int, dp, dp, dp, i64p]
        lib.tmalign_c.restype = ctypes.c_int
        _lib = lib
        logger.info("native host library loaded (%s)", _SO)
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def reverse_sw(prof_aa: np.ndarray, prof_ss: np.ndarray,
               t_aa: np.ndarray, t_ss: np.ndarray,
               gap_open: int, gap_extend: int, terminate: int):
    lib = get_lib()
    if lib is None:
        return None
    pa = np.ascontiguousarray(prof_aa, dtype=np.int32)
    ps = np.ascontiguousarray(prof_ss, dtype=np.int32)
    ta = np.ascontiguousarray(t_aa, dtype=np.int8)
    ts = np.ascontiguousarray(t_ss, dtype=np.int8)
    out = np.zeros(3, dtype=np.int64)
    lib.reverse_sw(_ptr(pa, ctypes.c_int32), _ptr(ps, ctypes.c_int32),
                   pa.shape[1], _ptr(ta, ctypes.c_int8), _ptr(ts, ctypes.c_int8),
                   len(ta), gap_open, gap_extend, terminate,
                   _ptr(out, ctypes.c_int64))
    return int(out[0]), int(out[1]), int(out[2])


def banded_sw_bt(sub: np.ndarray, score: int, gap_open: int, gap_extend: int):
    lib = get_lib()
    if lib is None:
        return None
    sub = np.ascontiguousarray(sub, dtype=np.int32)
    qL, tL = sub.shape
    buf = ctypes.create_string_buffer(qL + tL + 2)
    n = lib.banded_sw_bt(_ptr(sub, ctypes.c_int32), qL, tL, score,
                         gap_open, gap_extend, buf)
    if n < 0:
        raise RuntimeError("banded traceback failed")
    return buf.raw[:n].decode("ascii")


def tm_score_aligned(x: np.ndarray, y: np.ndarray, norm_len: int):
    """x = matched target coords [n,3], y = matched query coords [n,3].
    Returns (tm, rmsd, u [3,3], t [3]) or None if the library is missing.
    Since r5 this runs the float-exact reference engine (tm_ref.hpp,
    bit-identical to TMaligner::computeAppoximateTMscore); the double
    engine stays callable as tm_score_aligned_f64."""
    lib = get_lib()
    if lib is None:
        return None
    if hasattr(lib, "tm_score_aligned_ref"):
        xf = np.ascontiguousarray(x, dtype=np.float32)
        yf = np.ascontiguousarray(y, dtype=np.float32)
        out = np.zeros(14, dtype=np.float64)
        rc = lib.tm_score_aligned_ref(
            _ptr(xf, ctypes.c_float), _ptr(yf, ctypes.c_float),
            len(xf), norm_len, _ptr(out, ctypes.c_double))
        if rc == 0:
            return (float(out[0]), float(out[1]),
                    out[2:11].reshape(3, 3).copy(), out[11:14].copy())
    return tm_score_aligned_f64(x, y, norm_len)


def tm_score_aligned_f64(x: np.ndarray, y: np.ndarray, norm_len: int):
    """The r1-r4 double-precision engine (numerically nicer; kept for
    A/B and as the fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    out = np.zeros(14, dtype=np.float64)
    rc = lib.tm_score_aligned(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                              len(x), norm_len, _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return (float(out[0]), float(out[1]),
            out[2:11].reshape(3, 3).copy(), out[11:14].copy())


def tm_search8(xtm: np.ndarray, ytm: np.ndarray, simplify_step: int,
               local_d0_search: float, score_d8: float, d0: float,
               lnorm: float, n_it: int = 10):
    """Iterative superposition search (TMscore8_search) in C.
    Returns (score, u [3,3], t [3]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(xtm, dtype=np.float64)
    y = np.ascontiguousarray(ytm, dtype=np.float64)
    out = np.zeros(13, dtype=np.float64)
    rc = lib.tm_search8(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                        len(x), int(simplify_step),
                        ctypes.c_double(local_d0_search),
                        ctypes.c_double(score_d8), ctypes.c_double(d0),
                        ctypes.c_double(lnorm), int(n_it),
                        _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return float(out[0]), out[1:10].reshape(3, 3).copy(), out[10:13].copy()


def dp_iter(x: np.ndarray, y: np.ndarray, y2x_seed: np.ndarray,
            g1: int, g2: int, iteration_max: int,
            local_d0_search: float, lnorm: float, d0: float,
            score_d8: float):
    """Native DP_iter. Returns (best_score, best_y2x | None) or None when
    the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    xf = np.ascontiguousarray(x, dtype=np.float32)
    yf = np.ascontiguousarray(y, dtype=np.float32)
    seed = np.ascontiguousarray(y2x_seed, dtype=np.int64)
    out_score = np.zeros(1, dtype=np.float64)
    out_y2x = np.zeros(len(yf), dtype=np.int64)
    found = np.zeros(1, dtype=np.int32)
    rc = lib.dp_iter_c(
        _ptr(xf, ctypes.c_float), len(xf), _ptr(yf, ctypes.c_float),
        len(yf), _ptr(seed, ctypes.c_int64), int(g1), int(g2),
        int(iteration_max), ctypes.c_double(local_d0_search),
        ctypes.c_double(lnorm), ctypes.c_double(d0),
        ctypes.c_double(score_d8), _ptr(out_score, ctypes.c_double),
        _ptr(out_y2x, ctypes.c_int64), _ptr(found, ctypes.c_int32))
    if rc != 0:
        return None
    return float(out_score[0]), (out_y2x if found[0] else None)


def nw_xyz(x: np.ndarray, y: np.ndarray, u: np.ndarray, t: np.ndarray,
           d02: float, gap_open: float, secx=None, secy=None):
    """Rotated-distance score matrix + TM-align NW in one native call.
    Returns y2x [ylen] or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    xf = np.ascontiguousarray(x, dtype=np.float32)
    yf = np.ascontiguousarray(y, dtype=np.float32)
    ud = np.ascontiguousarray(u, dtype=np.float64).reshape(-1)
    td = np.ascontiguousarray(t, dtype=np.float64)
    use_sec = secx is not None
    sx = np.ascontiguousarray(secx if use_sec else np.zeros(1), dtype=np.int8)
    sy = np.ascontiguousarray(secy if use_sec else np.zeros(1), dtype=np.int8)
    y2x = np.empty(len(yf), dtype=np.int64)
    rc = lib.nw_xyz_c(
        _ptr(xf, ctypes.c_float), len(xf), _ptr(yf, ctypes.c_float),
        len(yf), _ptr(ud, ctypes.c_double), _ptr(td, ctypes.c_double),
        ctypes.c_double(d02), ctypes.c_float(gap_open),
        _ptr(sx, ctypes.c_int8), _ptr(sy, ctypes.c_int8), int(use_sec),
        _ptr(y2x, ctypes.c_long))
    if rc != 0:
        return None
    return y2x


def score_fast_batch(x: np.ndarray, y: np.ndarray, y2x_batch: np.ndarray,
                     d0: float, d0_search: float):
    """get_score_fast over a [n, ylen] batch of candidate alignments in one
    call. Returns scores [n] or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    xf = np.ascontiguousarray(x, dtype=np.float32)
    yf = np.ascontiguousarray(y, dtype=np.float32)
    batch = np.ascontiguousarray(y2x_batch, dtype=np.int64)
    n = len(batch)
    out = np.zeros(n, dtype=np.float64)
    rc = lib.score_fast_batch(
        _ptr(xf, ctypes.c_float), _ptr(yf, ctypes.c_float), len(yf),
        _ptr(batch, ctypes.c_int64), n, ctypes.c_double(d0),
        ctypes.c_double(d0_search), _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return out


def score_fast(xtm: np.ndarray, ytm: np.ndarray, d0: float,
               d0_search: float):
    """get_score_fast three-Kabsch scorer over a gathered alignment
    (float32 engine, like the reference's TM-align). Returns the score,
    or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(xtm, dtype=np.float32)
    y = np.ascontiguousarray(ytm, dtype=np.float32)
    out = np.zeros(1, dtype=np.float64)
    rc = lib.score_fast(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float),
                        len(x), ctypes.c_double(d0),
                        ctypes.c_double(d0_search),
                        _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return float(out[0])


def tm_search8f(xtm: np.ndarray, ytm: np.ndarray, simplify_step: int,
                local_d0_search: float, score_d8: float, d0: float,
                lnorm: float, n_it: int = 10):
    """Float32-engine TMscore8 search (full-TM-align path).
    Returns (score, u [3,3], t [3]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(xtm, dtype=np.float32)
    y = np.ascontiguousarray(ytm, dtype=np.float32)
    out = np.zeros(13, dtype=np.float64)
    rc = lib.tm_search8f(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float),
                         len(x), int(simplify_step),
                         ctypes.c_double(local_d0_search),
                         ctypes.c_double(score_d8), ctypes.c_double(d0),
                         ctypes.c_double(lnorm), int(n_it),
                         _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return float(out[0]), out[1:10].reshape(3, 3).copy(), out[10:13].copy()


def nw_gotoh_f32(score: np.ndarray, gap_open: float, gap_extend: float):
    """Gotoh NW traceback over a float32 score matrix. Returns y2x or None."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(score, dtype=np.float32)
    ylen, xlen = s.shape
    y2x = np.empty(ylen, dtype=np.int64)
    rc = lib.nw_gotoh_f32(_ptr(s, ctypes.c_float), ylen, xlen,
                          ctypes.c_float(gap_open), ctypes.c_float(gap_extend),
                          _ptr(y2x, ctypes.c_long))
    if rc != 0:
        return None
    return y2x


def tmalign_full(x: np.ndarray, y: np.ndarray, fast: bool):
    """Full TM-align (x = target, y = query coords [L,3]) in one native
    call. Returns (tm_query, tm_target, rmsd, n_ali8, u, t, sel_y2x) or
    None when the library is missing; raises nothing — a -1 rc (no
    alignment) returns the string "none"."""
    lib = get_lib()
    if lib is None:
        return None
    xf = np.ascontiguousarray(x, dtype=np.float32)
    yf = np.ascontiguousarray(y, dtype=np.float32)
    out4 = np.zeros(4, dtype=np.float64)
    u = np.zeros(9, dtype=np.float64)
    tv = np.zeros(3, dtype=np.float64)
    sel = np.empty(len(yf), dtype=np.int64)
    rc = lib.tmalign_c(_ptr(xf, ctypes.c_float), len(xf),
                       _ptr(yf, ctypes.c_float), len(yf), int(fast),
                       _ptr(out4, ctypes.c_double), _ptr(u, ctypes.c_double),
                       _ptr(tv, ctypes.c_double), _ptr(sel, ctypes.c_int64))
    if rc != 0:
        return "none"
    return (float(out4[0]), float(out4[1]), float(out4[2]), int(out4[3]),
            u.reshape(3, 3), tv, sel)


def posting_candidates(post_ids, post_off, post_tid, post_pos,
                       K, P, n_targets, prof, seqs_flat, seq_off, seq_len):
    """Posting lookup + double-diagonal detection + per-candidate Kadane +
    best-per-target reduction for one query in a single call. Returns
    (tid, count, d16) arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    pi = np.ascontiguousarray(post_ids, dtype=np.int64)
    po = np.ascontiguousarray(post_off, dtype=np.int64)
    pt = np.ascontiguousarray(post_tid, dtype=np.int64)
    pp = np.ascontiguousarray(post_pos, dtype=np.int64)
    Ka = np.ascontiguousarray(K, dtype=np.int64)
    Pa = np.ascontiguousarray(P, dtype=np.int64)
    pr = np.ascontiguousarray(prof, dtype=np.int32)
    sf = np.ascontiguousarray(seqs_flat, dtype=np.int8)
    so = np.ascontiguousarray(seq_off, dtype=np.int64)
    sl = np.ascontiguousarray(seq_len, dtype=np.int32)
    out_t = np.empty(int(n_targets), dtype=np.int64)
    out_c = np.empty(int(n_targets), dtype=np.int32)
    out_d = np.empty(int(n_targets), dtype=np.int64)
    m = lib.posting_candidates(
        _ptr(pi, ctypes.c_int64), len(pi), _ptr(po, ctypes.c_int64),
        _ptr(pt, ctypes.c_int64), _ptr(pp, ctypes.c_int64),
        _ptr(Ka, ctypes.c_int64), _ptr(Pa, ctypes.c_int64), len(Ka),
        ctypes.c_int64(int(n_targets)),
        _ptr(pr, ctypes.c_int32), len(pr), _ptr(sf, ctypes.c_int8),
        _ptr(so, ctypes.c_int64), _ptr(sl, ctypes.c_int32),
        _ptr(out_t, ctypes.c_int64), _ptr(out_c, ctypes.c_int32),
        _ptr(out_d, ctypes.c_int64))
    if m < 0:
        return None
    return out_t[:m], out_c[:m], out_d[:m]


def double_diag_detect(tid: np.ndarray, d16: np.ndarray, n_targets: int):
    """Double-diagonal candidate detection over posting matches in arrival
    order. Returns (cand_tid, cand_d16) int64 arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    td = np.ascontiguousarray(tid, dtype=np.int64)
    dd = np.ascontiguousarray(d16, dtype=np.int64)
    n = len(td)
    out_t = np.empty(n, dtype=np.int64)
    out_d = np.empty(n, dtype=np.int64)
    m = lib.double_diag_detect(
        _ptr(td, ctypes.c_int64), _ptr(dd, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int64(int(n_targets)),
        _ptr(out_t, ctypes.c_int64), _ptr(out_d, ctypes.c_int64))
    if m < 0:
        return None
    return out_t[:m], out_d[:m]


def diag_score_batch(prof: np.ndarray, seqs_flat: np.ndarray,
                     seq_off: np.ndarray, seq_len: np.ndarray,
                     tids: np.ndarray, d16s: np.ndarray):
    """Exact ungapped diagonal Kadane for a whole candidate list in one
    call. prof: [lq, 21] int; returns int32 scores [n] or None."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(prof, dtype=np.int32)
    sf = np.ascontiguousarray(seqs_flat, dtype=np.int8)
    so = np.ascontiguousarray(seq_off, dtype=np.int64)
    sl = np.ascontiguousarray(seq_len, dtype=np.int32)
    td = np.ascontiguousarray(tids, dtype=np.int64)
    dd = np.ascontiguousarray(d16s, dtype=np.int32)
    n = len(td)
    out = np.zeros(n, dtype=np.int32)
    rc = lib.diag_score_batch(
        _ptr(p, ctypes.c_int32), len(p), _ptr(sf, ctypes.c_int8),
        _ptr(so, ctypes.c_int64), _ptr(sl, ctypes.c_int32),
        _ptr(td, ctypes.c_int64), _ptr(dd, ctypes.c_int32), n,
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        return None
    return out


def batch_gates(q_ca, q_deg, t_cas, q_starts, t_starts, backtraces,
                norm_lens, need_tm: bool, need_lddt: bool):
    """Batched TM (+u/t/rmsd) and/or LDDT for a block of one query's hits
    in ONE ctypes call (the host analogue of the device survivor-gating
    phase). t_cas: list of [Lt,3] float32 arrays, backtraces: list of
    M/I/D strings. Returns dict with 'tm','rmsd','u','t','lddt' arrays
    (keys present per need flags), or None when the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(t_cas)
    if n == 0:
        return {}
    q = np.ascontiguousarray(q_ca, dtype=np.float32)
    deg = (np.ascontiguousarray(q_deg, dtype=np.float32)
           if need_lddt else np.zeros(1, dtype=np.float32))
    t_res = np.array([len(t) for t in t_cas], dtype=np.int64)
    t_off = np.zeros(n, dtype=np.int64)
    np.cumsum(t_res[:-1], out=t_off[1:])
    t_flat = (np.concatenate(
        [np.ascontiguousarray(t, dtype=np.float32).reshape(-1)
         for t in t_cas]) if n else np.zeros(0, np.float32))
    bt_len = np.array([len(b) for b in backtraces], dtype=np.int32)
    bt_off = np.zeros(n, dtype=np.int64)
    np.cumsum(bt_len[:-1].astype(np.int64), out=bt_off[1:])
    bt_flat = "".join(backtraces).encode("ascii")
    qs = np.ascontiguousarray(q_starts, dtype=np.int32)
    ts = np.ascontiguousarray(t_starts, dtype=np.int32)
    nl = np.ascontiguousarray(norm_lens, dtype=np.int32)
    tm = np.zeros(n, dtype=np.float64)
    rmsd = np.zeros(n, dtype=np.float64)
    u = np.zeros(n * 9, dtype=np.float64)
    tv = np.zeros(n * 3, dtype=np.float64)
    ld = np.zeros(n, dtype=np.float64)
    rc = lib.batch_gates(
        _ptr(q, ctypes.c_float), len(q), _ptr(deg, ctypes.c_float),
        _ptr(t_flat, ctypes.c_float), _ptr(t_off, ctypes.c_int64),
        _ptr(qs, ctypes.c_int32), _ptr(ts, ctypes.c_int32),
        bt_flat, _ptr(bt_off, ctypes.c_int64), _ptr(bt_len, ctypes.c_int32),
        _ptr(nl, ctypes.c_int32), n, int(need_tm), int(need_lddt),
        _ptr(tm, ctypes.c_double), _ptr(rmsd, ctypes.c_double),
        _ptr(u, ctypes.c_double), _ptr(tv, ctypes.c_double),
        _ptr(ld, ctypes.c_double))
    if rc != 0:
        return None
    out = {}
    if need_tm:
        out["tm"] = tm
        out["rmsd"] = rmsd
        out["u"] = u.reshape(n, 3, 3)
        out["t"] = tv.reshape(n, 3)
    if need_lddt:
        out["lddt"] = ld
    return out



def lol_block(dist_q: np.ndarray, dist_t: np.ndarray,
              anchors_q: np.ndarray, anchors_t: np.ndarray,
              g0: int, g1: int, g2: int, g3: int,
              w1: np.ndarray, b1: np.ndarray, w2: np.ndarray, b2: float,
              lol_m: np.ndarray):
    """LoLalign lolMatrix block accumulation (adds into lol_m in place).
    Returns (min_row, max_row) of contributing rows, or None without the
    native library. w1 is the [2, 3] input-weight matrix."""
    lib = get_lib()
    if lib is None:
        return None
    dist_q = np.ascontiguousarray(dist_q, dtype=np.float32)
    dist_t = np.ascontiguousarray(dist_t, dtype=np.float32)
    aq = np.ascontiguousarray(anchors_q, dtype=np.int64)
    at = np.ascontiguousarray(anchors_t, dtype=np.int64)
    assert lol_m.dtype == np.float32 and lol_m.flags.c_contiguous
    w1f = np.ascontiguousarray(w1, dtype=np.float32)   # [2, 3]
    b1f = np.ascontiguousarray(b1, dtype=np.float32)
    w2f = np.ascontiguousarray(w2, dtype=np.float32)
    minmax = np.array([dist_q.shape[0], 0], dtype=np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.lol_block(dist_q.ctypes.data_as(fp), dist_q.shape[0],
                  dist_t.ctypes.data_as(fp), dist_t.shape[0],
                  aq.ctypes.data_as(i64p), at.ctypes.data_as(i64p),
                  len(aq), g0, g1, g2, g3,
                  w1f.ctypes.data_as(fp), b1f.ctypes.data_as(fp),
                  w2f.ctypes.data_as(fp), ctypes.c_float(float(b2)),
                  lol_m.ctypes.data_as(fp), minmax.ctypes.data_as(i64p))
    return int(minmax[0]), int(minmax[1])


def fwbw_posterior(s: np.ndarray, go: float, ge: float, temperature: float):
    """Scaled linear-space FwBw posterior. Returns (P, max_p) or None
    without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, dtype=np.float64)
    L1, L2 = s.shape
    P = np.empty((L1, L2), dtype=np.float64)
    mp = np.zeros(1, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.fwbw_posterior_c(s.ctypes.data_as(dp), L1, L2,
                         ctypes.c_double(go), ctypes.c_double(ge),
                         ctypes.c_double(temperature),
                         P.ctypes.data_as(dp), mp.ctypes.data_as(dp))
    return P, float(mp[0])


def lolalign_full(lol_m0: np.ndarray, dist_q: np.ndarray, dist_t: np.ndarray,
                  sal: int, multi_domain: bool,
                  w1: np.ndarray, b1: np.ndarray, w2: np.ndarray, b2: float,
                  sa_go: float, sa_ge: float, sa_t: float,
                  lol_go: float, lol_ge: float, lol_t: float,
                  lol_min_p: float, num_start_anchors: int,
                  seed_number: int):
    """Full LoLalign orchestration. Returns (aq, at) int8 state arrays of
    the winning anchor set, "none" when no alignment exists, or None
    without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    lol_m0 = np.ascontiguousarray(lol_m0, dtype=np.float32)
    dist_q = np.ascontiguousarray(dist_q, dtype=np.float32)
    dist_t = np.ascontiguousarray(dist_t, dtype=np.float32)
    qL, tL = lol_m0.shape
    aq = np.zeros(qL, dtype=np.int8)
    at = np.zeros(tL, dtype=np.int8)
    found = np.zeros(1, dtype=np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    i8p_ = ctypes.POINTER(ctypes.c_int8)
    i32p_ = ctypes.POINTER(ctypes.c_int32)
    w1f = np.ascontiguousarray(w1, dtype=np.float32)
    b1f = np.ascontiguousarray(b1, dtype=np.float32)
    w2f = np.ascontiguousarray(w2, dtype=np.float32)
    lib.lolalign_c(lol_m0.ctypes.data_as(fp), qL, tL,
                   dist_q.ctypes.data_as(fp), dist_t.ctypes.data_as(fp),
                   sal, 1 if multi_domain else 0,
                   w1f.ctypes.data_as(fp), b1f.ctypes.data_as(fp),
                   w2f.ctypes.data_as(fp), ctypes.c_float(float(b2)),
                   sa_go, sa_ge, sa_t, lol_go, lol_ge, lol_t,
                   lol_min_p, num_start_anchors, seed_number,
                   aq.ctypes.data_as(i8p_), at.ctypes.data_as(i8p_),
                   found.ctypes.data_as(i32p_))
    if not found[0]:
        return "none"
    return aq, at


def lol_anchor_score(aq: np.ndarray, at: np.ndarray, lol_m0: np.ndarray,
                     dist_q: np.ndarray, dist_t: np.ndarray,
                     w1: np.ndarray, b1: np.ndarray, w2: np.ndarray,
                     b2: float):
    """Anchor-set LoL scoring. Returns (total, max_lol, norm_selfhit,
    fa_q, fa_t) or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    aq = np.ascontiguousarray(aq, dtype=np.int8)
    at = np.ascontiguousarray(at, dtype=np.int8)
    lol_m0 = np.ascontiguousarray(lol_m0, dtype=np.float32)
    dist_q = np.ascontiguousarray(dist_q, dtype=np.float32)
    dist_t = np.ascontiguousarray(dist_t, dtype=np.float32)
    qL, tL = lol_m0.shape
    nmax = min(qL, tL)
    fa_q = np.zeros(nmax, dtype=np.int64)
    fa_t = np.zeros(nmax, dtype=np.int64)
    nn_ = np.zeros(1, dtype=np.int32)
    out3 = np.zeros(3, dtype=np.float64)
    fp = ctypes.POINTER(ctypes.c_float)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    dpp = ctypes.POINTER(ctypes.c_double)
    w1f = np.ascontiguousarray(w1, dtype=np.float32)
    b1f = np.ascontiguousarray(b1, dtype=np.float32)
    w2f = np.ascontiguousarray(w2, dtype=np.float32)
    lib.lol_anchor_score_c(aq.ctypes.data_as(i8), at.ctypes.data_as(i8),
                           qL, tL, lol_m0.ctypes.data_as(fp),
                           dist_q.ctypes.data_as(fp),
                           dist_t.ctypes.data_as(fp),
                           w1f.ctypes.data_as(fp), b1f.ctypes.data_as(fp),
                           w2f.ctypes.data_as(fp),
                           ctypes.c_float(float(b2)),
                           fa_q.ctypes.data_as(i64),
                           fa_t.ctypes.data_as(i64),
                           nn_.ctypes.data_as(i32),
                           out3.ctypes.data_as(dpp))
    n = int(nn_[0])
    return (float(out3[0]), float(out3[1]), float(out3[2]),
            fa_q[:n], fa_t[:n])

def lddt_aligned(qa: np.ndarray, ta: np.ndarray, deg: np.ndarray):
    """C-alpha LDDT over aligned columns. Returns (avg, per_col, score_len)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    qa = np.ascontiguousarray(qa, dtype=np.float32)
    ta = np.ascontiguousarray(ta, dtype=np.float32)
    deg = np.ascontiguousarray(deg, dtype=np.float32)
    m = len(qa)
    out = np.zeros(2, dtype=np.float64)
    per_col = np.zeros(m, dtype=np.float32)
    fn = (lib.lddt_aligned_ref if hasattr(lib, "lddt_aligned_ref")
          else lib.lddt_aligned)
    rc = fn(_ptr(qa, ctypes.c_float), _ptr(ta, ctypes.c_float),
            _ptr(deg, ctypes.c_float), m,
            _ptr(out, ctypes.c_double), _ptr(per_col, ctypes.c_float))
    if rc != 0:
        return None
    return float(out[0]), per_col, int(out[1])


def lddt_degree(q_ca: np.ndarray):
    """Full-query <15A neighbor counts with the reference's exact float
    distance (LDDT.cpp initQuery); None if the lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lddt_degree_ref"):
        return None
    q = np.ascontiguousarray(q_ca, dtype=np.float32)
    out = np.zeros(len(q), dtype=np.float32)
    rc = lib.lddt_degree_ref(_ptr(q, ctypes.c_float), len(q),
                             _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def fwbw_forward_m(s: np.ndarray, go: float, ge: float):
    """Log-space FwBw forward match matrix; None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, dtype=np.float64)
    L1, L2 = s.shape
    M = np.empty((L1, L2), dtype=np.float64)
    rc = lib.fwbw_forward_m(_ptr(s, ctypes.c_double), L1, L2,
                            float(go), float(ge), _ptr(M, ctypes.c_double))
    if rc != 0:
        return None
    return M


def batch_recover(fprof_aa, fprof_ss, prof_aa, prof_ss, q_aa,
                  db_aa, db_ss, t_off, t_end, score, q_end,
                  gap_open: int, gap_extend: int):
    """Batched start+traceback recovery for one query's survivor list —
    ONE ctypes call instead of two per hit. Returns (q_start, t_start,
    ident, ops_list) arrays; ops_list[i] is None where the C side failed
    (band overflow) and the caller falls back per-hit."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(t_off)
    if n == 0:
        return (np.zeros(0, np.int32),) * 3 + ([],)
    fpa = np.ascontiguousarray(fprof_aa, dtype=np.int32)
    fps = np.ascontiguousarray(fprof_ss, dtype=np.int32)
    pa = np.ascontiguousarray(prof_aa, dtype=np.int32)
    ps = np.ascontiguousarray(prof_ss, dtype=np.int32)
    qa = np.ascontiguousarray(q_aa, dtype=np.int8)
    t_off = np.ascontiguousarray(t_off, dtype=np.int64)
    t_end = np.ascontiguousarray(t_end, dtype=np.int32)
    score = np.ascontiguousarray(score, dtype=np.int32)
    q_end = np.ascontiguousarray(q_end, dtype=np.int32)
    caps = (q_end.astype(np.int64) + t_end + 3)
    ops_off = np.zeros(n, dtype=np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    total = int(caps.sum())
    out_qs = np.zeros(n, dtype=np.int32)
    out_ts = np.zeros(n, dtype=np.int32)
    out_id = np.zeros(n, dtype=np.int32)
    out_len = np.zeros(n, dtype=np.int32)
    ops_buf = ctypes.create_string_buffer(total)
    lib.batch_recover(
        _ptr(fpa, ctypes.c_int32), _ptr(fps, ctypes.c_int32),
        _ptr(pa, ctypes.c_int32), _ptr(ps, ctypes.c_int32),
        _ptr(qa, ctypes.c_int8), fpa.shape[1],
        _ptr(np.ascontiguousarray(db_aa, dtype=np.int8), ctypes.c_int8),
        _ptr(np.ascontiguousarray(db_ss, dtype=np.int8), ctypes.c_int8),
        _ptr(t_off, ctypes.c_int64), _ptr(t_end, ctypes.c_int32),
        _ptr(score, ctypes.c_int32), _ptr(q_end, ctypes.c_int32),
        n, int(gap_open), int(gap_extend),
        _ptr(out_qs, ctypes.c_int32), _ptr(out_ts, ctypes.c_int32),
        _ptr(out_id, ctypes.c_int32), ops_buf,
        _ptr(ops_off, ctypes.c_int64), _ptr(out_len, ctypes.c_int32))
    raw = ops_buf.raw
    ops = [raw[ops_off[i]: ops_off[i] + out_len[i]].decode("ascii")
           if out_len[i] >= 0 else None
           for i in range(n)]
    return out_qs, out_ts, out_id, ops


def batch_recover_block(q_aa_rev, q_ss_rev, bias_rev,
                        mat_aa, mat_ss, db_aa, db_ss,
                        t_off, t_end, score, q_end,
                        gap_open: int, gap_extend: int):
    """Batched block-aligner backtraces — the reference's DEFAULT
    non-profile path (alignStartPosBacktraceBlock,
    StructureSmithWaterman.cpp:369-527; algorithm reimplemented in
    native/block_aligner.hpp). Returns (q_start, t_start, ident, ops_list);
    ops_list[i] is the string "BLOCK_FAIL" sentinel where the exponential
    block-size search could not reproduce the forward score — the caller
    must then emit the reference's failure row (score1 = UINT32_MAX path).
    Returns None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "batch_recover_block"):
        return None
    n = len(t_off)
    if n == 0:
        return (np.zeros(0, np.int32),) * 3 + ([],)
    qa = np.ascontiguousarray(q_aa_rev, dtype=np.int8)
    qs = np.ascontiguousarray(q_ss_rev, dtype=np.int8)
    bias = np.ascontiguousarray(bias_rev, dtype=np.int16)
    maa = np.ascontiguousarray(mat_aa, dtype=np.int8)
    mss = np.ascontiguousarray(mat_ss, dtype=np.int8)
    t_off = np.ascontiguousarray(t_off, dtype=np.int64)
    t_end = np.ascontiguousarray(t_end, dtype=np.int32)
    score = np.ascontiguousarray(score, dtype=np.int32)
    q_end = np.ascontiguousarray(q_end, dtype=np.int32)
    caps = (q_end.astype(np.int64) + t_end + 3)
    ops_off = np.zeros(n, dtype=np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    total = int(caps.sum())
    out_qs = np.zeros(n, dtype=np.int32)
    out_ts = np.zeros(n, dtype=np.int32)
    out_id = np.zeros(n, dtype=np.int32)
    out_len = np.zeros(n, dtype=np.int32)
    ops_buf = ctypes.create_string_buffer(total)
    lib.batch_recover_block(
        _ptr(qa, ctypes.c_int8), _ptr(qs, ctypes.c_int8),
        _ptr(bias, ctypes.c_int16), len(qa),
        _ptr(maa, ctypes.c_int8), _ptr(mss, ctypes.c_int8),
        _ptr(np.ascontiguousarray(db_aa, dtype=np.int8), ctypes.c_int8),
        _ptr(np.ascontiguousarray(db_ss, dtype=np.int8), ctypes.c_int8),
        _ptr(t_off, ctypes.c_int64), _ptr(t_end, ctypes.c_int32),
        _ptr(score, ctypes.c_int32), _ptr(q_end, ctypes.c_int32),
        n, int(gap_open), int(gap_extend),
        _ptr(out_qs, ctypes.c_int32), _ptr(out_ts, ctypes.c_int32),
        _ptr(out_id, ctypes.c_int32), ops_buf,
        _ptr(ops_off, ctypes.c_int64), _ptr(out_len, ctypes.c_int32))
    raw = ops_buf.raw
    ops = [raw[ops_off[i]: ops_off[i] + out_len[i]].decode("ascii")
           if out_len[i] >= 0 else "BLOCK_FAIL"
           for i in range(n)]
    return out_qs, out_ts, out_id, ops


def dist_matrix(ca: np.ndarray, cutoff: bool):
    """[L, L] float32 pairwise distances (bit-identical to the numpy
    broadcast form); None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ca = np.ascontiguousarray(ca, dtype=np.float32)
    L = len(ca)
    out = np.empty((L, L), dtype=np.float32)
    rc = lib.dist_matrix_c(_ptr(ca, ctypes.c_float), L, int(cutoff),
                           _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def lol_init_query_vec(dist_q: np.ndarray, sd_table: np.ndarray,
                       w1, b1, w2, b2, lol_vec: np.ndarray) -> bool:
    """Accumulate the LoLalign initQuery self-score rows into lol_vec
    (float64, in place); sd_table = numpy seq-dist values for
    diff in [-(L-1), L-1]. Returns False if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    dq = np.ascontiguousarray(dist_q, dtype=np.float32)
    sd = np.ascontiguousarray(sd_table, dtype=np.float32)
    w1f = np.ascontiguousarray(np.asarray(w1, np.float32).reshape(-1))
    b1f = np.ascontiguousarray(np.asarray(b1, np.float32).reshape(-1))
    w2f = np.ascontiguousarray(np.asarray(w2, np.float32).reshape(-1))
    rc = lib.lol_init_query_vec(
        _ptr(dq, ctypes.c_float), len(dq), _ptr(sd, ctypes.c_float),
        _ptr(w1f, ctypes.c_float),
        _ptr(b1f, ctypes.c_float), _ptr(w2f, ctypes.c_float),
        ctypes.c_float(float(np.asarray(b2).reshape(-1)[0])),
        _ptr(lol_vec, ctypes.c_double))
    return rc == 0

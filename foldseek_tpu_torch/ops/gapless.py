"""Ungapped (gapless) diagonal prefilter scores.

Counterpart of `foldseek_tpu/ops/gapless_pallas.py`: the packing helpers, the
wrappers of the CUDA kernel in `csrc/gapless.cu` and their plain PyTorch
versions. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.

Layout. Query profiles form a ragged stack: `prof` int32 [rows, 32] holds
every query's rows back to back (lanes 0..20 = target letter, lanes 21..31 =
NEG), `q_off` int32 [q + 1] the row offsets and `caps` int32 [q] each query's
byte-saturation cap. The TPU kernel needed equal-height slots separated by
pad rows; a per-query offset does the same job. Targets stay in the
transposed int8 panel layout [Lt, B] of `foldseek_tpu/db/panels.py`, pad
letter 21: neighbouring CUDA threads then read neighbouring bytes.

Semantics (`_make_kernel_batch`): per query, per target,
h = min(max(h_diag + prof[i, t_j], 0), cap), best = max(best, h) over every
cell; the diagonal starts from 0 at the query's first row and the target's
first column. A query of any length is the same launch:
`gapless_scores_batch` covers K1, the slab-chained long-query kernel K2
(`_make_kernel_long`) and the one-query kernel K5 (`_make_kernel_single`: a
stack of one, with `NO_CAP` where it had no cap) of the JAX package.
`gapless_scores_dual` is the dual-alphabet scan K6 (`_make_kernel_dual`):
s = prof_aa[i, t_aa_j] + prof_ss[i, t_ss_j] over two panels of equal shape,
no cap.

On the card. One thread per target walks the target's columns with a strip
of consecutive query rows in registers; the kernel keeps the query's profile
in shared memory as int16, letter-major (one 128-bit load brings eight rows
of a letter), so profile entries (lanes 0..20) must lie in int8 range; the
wrapper checks and raises. `can_pack` decides from the caps, the profile
range and the lengths whether the packed 16-bit kernel (two rows a register)
is exact; otherwise the 32-bit kernel runs. The kernel gives each query the
shortest strip that holds it (`strip_rows`); a query taller than the tallest
strip runs in passes that hand one value per column through a scratch tensor
of the wrapper. `plan_gapless_launch` shrinks the block when a launch has
few (query, target tile) items, so that one query still spreads over the
card. Pad columns beyond the longest real target of a warp are not walked.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

PAD_LETTER = 21
PROF_LANES = 32
# pad-lane score: resets h to 0 (h + NEG < 0 for any h <= cap) and cannot
# overflow int32 in one add
NEG = -(1 << 24)
# a cap no running score reaches (profile scores stay below 2**20): min(h,
# NO_CAP) is the identity
NO_CAP = 2**31 - 1
# strip heights (query rows a pass holds in registers) the kernels are built
# for: two rows a register when packed, one otherwise (csrc/gapless.cu Strips)
PACKED_ROWS = (32, 64, 96, 128, 160, 192)
WIDE_ROWS = (32,)
PROFILE_MIN, PROFILE_MAX = -128, 127   # int8 range, checked per launch
# largest running score of the packed kernel: with PROFILE_MAX added it still
# fits int16
PACKED_CAP_MAX = 32767 - 255
MAX_THREADS, MIN_THREADS = 128, 32
# (query, target tile) items below which a launch takes smaller blocks, and
# the most blocks a launch starts (they walk over the items); a launch with
# passes starts fewer, each block owning [Lt, threads] of scratch
TARGET_ITEMS = 132 * 8
MAX_BLOCKS, MAX_BLOCKS_PASSES = 132 * 8, 132 * 4


def pack_profile(prof: np.ndarray) -> np.ndarray:
    """[21, Lq] integer-valued profile -> int32 [Lq, 32] rows, lanes 21..31
    = NEG."""
    prof = np.asarray(prof)
    ip = np.rint(prof).astype(np.int64)
    if not np.array_equal(ip, prof) or np.abs(ip).max(initial=0) >= (1 << 20):
        raise ValueError("gapless profiles must hold integer scores below 2**20")
    out = np.full((prof.shape[1], PROF_LANES), NEG, dtype=np.int32)
    out[:, :prof.shape[0]] = ip.T
    return out


def pack_profiles_batch(profs, caps):
    """Stack per-query [21, L_i] profiles for `gapless_scores_batch`.

    Returns numpy (prof int32 [sum L_i, 32], q_off int32 [q + 1],
    caps int32 [q])."""
    lens = [int(p.shape[1]) for p in profs]
    q_off = np.zeros(len(profs) + 1, dtype=np.int64)
    np.cumsum(lens, out=q_off[1:])
    if q_off[-1] >= 2**31:
        raise ValueError("query stack too tall for int32 row offsets")
    stack = (np.concatenate([pack_profile(p) for p in profs])
             if profs else np.zeros((0, PROF_LANES), np.int32))
    caps_i = np.rint(np.asarray(caps, dtype=np.float64)).astype(np.int32)
    return stack, q_off.astype(np.int32), caps_i


# --- plain PyTorch versions --------------------------------------------------

def _diagonal_scan_torch(col_scores, n_rows: int, q_off: torch.Tensor,
                         caps, Lt: int, B: int, dev) -> torch.Tensor:
    """Column scan over a whole ragged stack, [rows, B] of state:
    `col_scores(j)` gives the int32 [rows, B] cell scores of target column
    j; `caps` int [q] or None. Returns int32 [q, B]."""
    offs = q_off.to("cpu", torch.long)
    q = offs.numel() - 1
    lens = offs.diff()
    row_q = torch.repeat_interleave(torch.arange(q), lens).to(dev)
    cap_row = (None if caps is None
               else caps.to(dev, torch.int32)[row_q][:, None])
    first = torch.zeros(n_rows, dtype=torch.bool)
    first[offs[:-1][lens > 0]] = True
    first = first.to(dev)[:, None]
    zero_row = torch.zeros((1, B), dtype=torch.int32, device=dev)
    h = torch.zeros((n_rows, B), dtype=torch.int32, device=dev)
    best = torch.zeros_like(h)
    for j in range(Lt):
        diag = torch.cat([zero_row, h[:-1]]).masked_fill_(first, 0)
        h = torch.clamp_min(diag + col_scores(j), 0)
        if cap_row is not None:
            h = torch.minimum(h, cap_row)
        best = torch.maximum(best, h)
    out = torch.zeros((q, B), dtype=torch.int32, device=dev)
    return out.scatter_reduce_(0, row_q[:, None].expand(-1, B), best, "amax")


def gapless_scores_batch_torch(prof: torch.Tensor, q_off: torch.Tensor,
                               caps: torch.Tensor,
                               t_T: torch.Tensor) -> torch.Tensor:
    """Plain version of `gapless_scores_batch`. Returns int32 [q, B]."""
    dev = t_T.device
    Lt, B = t_T.shape
    prof = prof.to(dev, torch.int32)
    return _diagonal_scan_torch(
        lambda j: prof[:, t_T[j].long() & (PROF_LANES - 1)],
        prof.shape[0], q_off, caps, Lt, B, dev)


def gapless_scores_dual_torch(prof_aa: torch.Tensor, prof_ss: torch.Tensor,
                              q_off: torch.Tensor, t_aa_T: torch.Tensor,
                              t_ss_T: torch.Tensor) -> torch.Tensor:
    """Plain version of `gapless_scores_dual`. Returns int32 [q, B]."""
    dev = t_aa_T.device
    Lt, B = t_aa_T.shape
    prof_aa = prof_aa.to(dev, torch.int32)
    prof_ss = prof_ss.to(dev, torch.int32)
    return _diagonal_scan_torch(
        lambda j: (prof_aa[:, t_aa_T[j].long() & (PROF_LANES - 1)]
                   + prof_ss[:, t_ss_T[j].long() & (PROF_LANES - 1)]),
        prof_aa.shape[0], q_off, None, Lt, B, dev)


# --- launch planning (pure Python) ------------------------------------------

def can_pack(cap_min: int, cap_max: int, prof_min: int, prof_max: int,
             max_len: int, lt: int) -> bool:
    """True when the packed 16-bit kernel is exact: no cap is negative, every
    profile entry lies in int8 range, and no running score can pass
    PACKED_CAP_MAX, either because every cap stops it there or because a
    diagonal of at most min(max_len, lt) cells of at most prof_max each cannot
    reach it (which lets an uncapped query of moderate length pack too). Then
    h stays in [0, PACKED_CAP_MAX] and h + s fits int16 at every cell."""
    reach = min(cap_max, min(max_len, lt) * max(prof_max, 0))
    return (0 <= cap_min and reach <= PACKED_CAP_MAX
            and PROFILE_MIN <= prof_min and prof_max <= PROFILE_MAX)


def strip_rows(length: int, packed: bool) -> int:
    """Query rows a pass of the kernel holds for a query of `length` rows: the
    shortest strip that holds it, or the tallest (and several passes)."""
    options = PACKED_ROWS if packed else WIDE_ROWS
    return next((rows for rows in options if length <= rows), options[-1])


def plan_gapless_launch(query_lens, n_targets: int, lt: int,
                        packed: bool) -> dict:
    """Launch shape: passes of the tallest query, threads per block, blocks,
    and the scratch elements the passes need (0 for one pass). The 32-bit instances halve the block while the launch has fewer
    than TARGET_ITEMS items; the packed instance keeps 128 threads, which
    share its eight copies of the profile tile (up to 63 KB a block)."""
    tallest = max((int(L) for L in query_lens), default=0)
    passes = -(-tallest // strip_rows(tallest, packed))
    threads = MAX_THREADS
    while not packed and threads > MIN_THREADS and \
            len(query_lens) * -(-n_targets // threads) < TARGET_ITEMS:
        threads //= 2
    items = len(query_lens) * -(-n_targets // threads)
    grid = max(1, min(items, MAX_BLOCKS_PASSES if passes > 1 else MAX_BLOCKS))
    return dict(passes=passes, threads=threads, grid=grid,
                scratch=grid * lt * threads if passes > 1 else 0)


# --- CUDA wrappers ------------------------------------------------------------

def _lib():
    from ._build import load
    lib = load("gapless").lib
    fn = lib.gapless_scores
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, p, p, p, i, p, i, i, ll, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.gapless_scores_dual.argtypes = [i, i, p, p, p, i, p, p, i, i, ll,
                                            ll, p, p, p, p]
        lib.gapless_scores_dual.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, ndim, dev):
    if t.device != dev:
        raise ValueError(f"{name} lies on {t.device}, expected {dev}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _stack_facts(q_off: torch.Tensor, *ranged):
    """One trip to the host: the queries' lengths and the (min, max) of each
    tensor in `ranged` (0, 0 for an empty one)."""
    zero = q_off.new_zeros(2)
    parts = [q_off] + [
        torch.stack(t.aminmax()) if t.numel() else zero for t in ranged]
    host = torch.cat(parts).tolist()
    n = q_off.numel()
    lens = [b - a for a, b in zip(host[:n - 1], host[1:n])]
    return lens, [tuple(host[n + 2 * k: n + 2 * k + 2])
                  for k in range(len(ranged))]


def check_profile_range(name: str, lo: int, hi: int) -> None:
    """Raise unless [lo, hi], the range of a profile's entries, fits the
    int16 tiles the kernels keep in shared memory (int8 range)."""
    if lo < PROFILE_MIN or hi > PROFILE_MAX:
        raise ValueError(f"{name} entries must lie in [{PROFILE_MIN}, "
                         f"{PROFILE_MAX}], got [{lo}, {hi}]")


def gapless_scores_batch(prof: torch.Tensor, q_off: torch.Tensor,
                         caps: torch.Tensor, t_T: torch.Tensor) -> torch.Tensor:
    """Best capped ungapped-diagonal score of each stacked query against each
    target of the panel t_T (int8 [Lt, B]). Returns int32 [q, B].

    Every launch of the gapless kernel goes through this function and adds
    one to `gapless_scores_batch.launches`."""
    dev = t_T.device
    if dev.type == "cpu":
        return gapless_scores_batch_torch(prof, q_off, caps, t_T)
    _check("prof", prof, torch.int32, 2, dev)
    _check("q_off", q_off, torch.int32, 1, dev)
    _check("caps", caps, torch.int32, 1, dev)
    _check("t_T", t_T, torch.int8, 2, dev)
    q = q_off.numel() - 1
    if prof.shape[1] != PROF_LANES or caps.numel() != q or q < 0:
        raise ValueError("prof must be [rows, 32] with one cap per query")
    if not (prof.is_contiguous() and q_off.is_contiguous()
            and caps.is_contiguous() and t_T.stride(1) == 1):
        raise ValueError("gapless kernel inputs must be contiguous")
    Lt, B = t_T.shape
    out = torch.empty((q, B), dtype=torch.int32, device=dev)
    if q == 0 or B == 0:
        return out
    lens, ((cap_min, cap_max), (p_min, p_max)) = _stack_facts(
        q_off, caps, prof[:, :PAD_LETTER])
    check_profile_range("gapless profile", p_min, p_max)
    packed = can_pack(cap_min, cap_max, p_min, p_max, max(lens), Lt)
    plan = plan_gapless_launch(lens, B, Lt, packed)
    t_len = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, plan["scratch"]), device=dev,
                          dtype=torch.int16 if packed else torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().gapless_scores(
            int(packed), plan["grid"], plan["threads"], prof.data_ptr(), q_off.data_ptr(), caps.data_ptr(), q,
            t_T.data_ptr(), Lt, B, t_T.stride(0), t_len.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gapless kernel launch failed: CUDA error {rc}")
    gapless_scores_batch.launches += 1
    return out


gapless_scores_batch.launches = 0


def gapless_scores_dual(prof_aa: torch.Tensor, prof_ss: torch.Tensor,
                        q_off: torch.Tensor, t_aa_T: torch.Tensor,
                        t_ss_T: torch.Tensor) -> torch.Tensor:
    """Best uncapped ungapped-diagonal score under the summed AA + 3Di
    profiles of each stacked query against each target of the two panels
    (int8 [Lt, B] each, pad letter 21 in both). Returns int32 [q, B].

    Every launch of the dual gapless kernel goes through this function and
    adds one to `gapless_scores_dual.launches`."""
    dev = t_aa_T.device
    if dev.type == "cpu":
        return gapless_scores_dual_torch(prof_aa, prof_ss, q_off, t_aa_T,
                                         t_ss_T)
    _check("prof_aa", prof_aa, torch.int32, 2, dev)
    _check("prof_ss", prof_ss, torch.int32, 2, dev)
    _check("q_off", q_off, torch.int32, 1, dev)
    _check("t_aa_T", t_aa_T, torch.int8, 2, dev)
    _check("t_ss_T", t_ss_T, torch.int8, 2, dev)
    q = q_off.numel() - 1
    if prof_aa.shape[1] != PROF_LANES or prof_ss.shape != prof_aa.shape \
            or t_ss_T.shape != t_aa_T.shape or q < 0:
        raise ValueError("profiles must be equal [rows, 32], panels equal "
                         "[Lt, B]")
    if not (prof_aa.is_contiguous() and prof_ss.is_contiguous()
            and q_off.is_contiguous() and t_aa_T.stride(1) == 1
            and t_ss_T.stride(1) == 1):
        raise ValueError("gapless kernel inputs must be contiguous")
    Lt, B = t_aa_T.shape
    out = torch.empty((q, B), dtype=torch.int32, device=dev)
    if q == 0 or B == 0:
        return out
    lens, (aa_range, ss_range) = _stack_facts(
        q_off, prof_aa[:, :PAD_LETTER], prof_ss[:, :PAD_LETTER])
    check_profile_range("dual gapless AA profile", *aa_range)
    check_profile_range("dual gapless 3Di profile", *ss_range)
    plan = plan_gapless_launch(lens, B, Lt, packed=False)
    t_len = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, plan["scratch"]), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().gapless_scores_dual(
            plan["grid"], plan["threads"], prof_aa.data_ptr(),
            prof_ss.data_ptr(), q_off.data_ptr(), q, t_aa_T.data_ptr(),
            t_ss_T.data_ptr(), Lt, B, t_aa_T.stride(0), t_ss_T.stride(0),
            t_len.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dual gapless kernel launch failed: CUDA error {rc}")
    gapless_scores_dual.launches += 1
    return out


gapless_scores_dual.launches = 0


def topk_rows(scores: torch.Tensor, k: int):
    """Each row's k best (int32 [q, k] scores, int64 [q, k] columns), ties
    to the lower column first: the order of `jax.lax.top_k`. Score and
    column are packed into one unique int64 key, so the selection does not
    depend on how `torch.topk` orders ties."""
    B = scores.shape[1]
    low = (1 << 32) - 1
    rows = torch.arange(B, device=scores.device, dtype=torch.long)
    key = (scores.long() << 32) | (low - rows)
    top = torch.topk(key, k, dim=1, sorted=True).values
    return (top >> 32).to(torch.int32), low - (top & low)


def gapless_topk_batch(prof: torch.Tensor, q_off: torch.Tensor,
                       caps: torch.Tensor, t_T: torch.Tensor, k: int):
    """Scores plus each query's top k panel rows (int32 [q, k] scores,
    int64 [q, k] rows), ties to the lower row first (`topk_rows`)."""
    return topk_rows(gapless_scores_batch(prof, q_off, caps, t_T), k)

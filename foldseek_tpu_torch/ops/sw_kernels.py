"""Dual-alphabet affine Smith-Waterman scoring of (slot, target) pairs.

Counterpart of `foldseek_tpu/ops/sw_pallas.py`: the wrappers of the CUDA
kernel in `csrc/sw.cu`, the packing they take and the plain PyTorch version
(`sw_scan_torch` in `ops/sw.py`). A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.

Layout. A *slot* is one query profile: `prof_aa` / `prof_ss` int32
[21, rows] hold every slot's [21, L] profile side by side and `slot_off`
[S + 1] their column offsets. Targets are the DB's concatenated residue
arrays `res_aa` / `res_ss` (int8); a *pair* is (slot, target) with the
target's residue offset and length. Pairs are grouped by slot:
`pair_start` [S + 1] gives each slot's range. The TPU's stacked slots with
pad rows, SEG_BIG staircase and padded target panels are not needed: one
`sw_scores_pairs` launch covers `sw_scores_batch_multi` (K3),
`sw_scores_batch` (K7) and `sw_scores_query` (K4) of the JAX package, and
queries of any length.

On the card. The kernel keeps a tile of the slot's profile in shared memory
as int16, letter-major (one 128-bit load brings eight rows of a letter), so
profile entries must lie in int8 range; the wrapper checks and raises. A
group of G lanes scores one pair, each lane holding S consecutive query rows
in registers; the kernel gives every slot the lane group that fits its
length (`sw_lane_group`), a slot taller than 256 rows runs in passes through
a scratch row per group, and an all-zero AA profile takes the kernel that
reads the 3Di profile only. The kernel finds its pairs from `pair_start`, so the plan
that goes to the card is `pair_toff` / `pair_tlen` alone, and a caller that
holds them on the card already uploads nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .gapless import check_profile_range
from .sw import sw_scan_torch

ALPHA = 21
THREADS = 128            # csrc/sw.cu kThreads
# (lanes per pair G, query rows per lane S) of the kernel's lane groups, by
# the tallest slot each serves in one pass; a taller slot runs in passes of
# the last one (csrc/sw.cu sw_kernel)
SW_GROUPS = ((32, (4, 8)), (64, (8, 8)), (128, (8, 16)), (192, (8, 24)),
             (256, (16, 16)))
SW_GROUP_IN_PASSES = (8, 24)
MAX_PAIRS_PER_BLOCK = 32   # csrc/sw.cu kMaxPairs: 128 threads of groups of 4
# blocks a launch aims for: 132 SMs, 16 blocks of 128 threads each
TARGET_BLOCKS = 132 * 16


def sw_lane_group(slot_len: int):
    """(G, S) of the lane group the kernel gives a slot of `slot_len` rows:
    the group with the fewest padded rows that holds the slot in one pass
    (of two alike, the one with fewer lanes: G - 1 steps of every target fill
    and drain a group), or (8, 24) in passes for a slot taller than 256."""
    return next((group for tallest, group in SW_GROUPS if slot_len <= tallest),
                SW_GROUP_IN_PASSES)


def plan_sw_launch(slot_lens, pair_counts, max_tlen: int) -> dict:
    """Launch shape of `sw_scores_pairs`: the passes of the tallest slot, the
    blocks per slot (each walks over chunks of 128 / G pairs of its slot) and
    the scratch size in int32 (two values per column for every group a block
    can hold, only when a slot needs more than one pass)."""
    groups = [sw_lane_group(int(L)) for L in slot_lens]
    passes = max(-(-int(L) // (G * S)) for L, (G, S) in zip(slot_lens, groups))
    chunks = max(-(-int(c) // (THREADS // G))
                 for c, (G, _) in zip(pair_counts, groups))
    nbx = max(1, min(chunks, -(-TARGET_BLOCKS // len(slot_lens))))
    scr_stride = 2 * int(max_tlen) if passes > 1 else 0
    return dict(passes=passes, nbx=nbx, scr_stride=scr_stride,
                scratch=len(slot_lens) * nbx * MAX_PAIRS_PER_BLOCK * scr_stride)


def pack_sw_slots(profs_aa, profs_ss):
    """Per-slot [21, L] int profiles -> numpy (prof_aa int32 [21, rows],
    prof_ss int32 [21, rows], slot_off int64 [S + 1])."""
    lens = [int(p.shape[1]) for p in profs_aa]
    slot_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=slot_off[1:])
    if len(lens) == 0:
        empty = np.zeros((ALPHA, 0), np.int32)
        return empty, empty.copy(), slot_off
    paa = np.ascontiguousarray(np.concatenate(profs_aa, axis=1), np.int32)
    pss = np.ascontiguousarray(np.concatenate(profs_ss, axis=1), np.int32)
    return paa, pss, slot_off


def _host_long(t) -> torch.Tensor:
    return torch.as_tensor(t).to("cpu", torch.long)


def sw_scores_pairs_torch(prof_aa, prof_ss, slot_off, pair_start, res_aa,
                          res_ss, pair_toff, pair_tlen, gap_open=10,
                          gap_extend=1):
    """Plain version of `sw_scores_pairs`: pads every slot to the longest and
    every target to the longest, then runs `sw_scan_torch`."""
    dev = res_aa.device
    so = _host_long(slot_off)
    ps = _host_long(pair_start)
    S = so.numel() - 1
    lens = so.diff()
    P = int(ps[-1]) if S else 0
    if P == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z.clone(), z.clone()
    Lm = int(lens.max())
    rows = (so[:-1, None] + torch.arange(Lm)).clamp(max=prof_aa.shape[1] - 1)
    rows = rows.to(dev)
    paa = prof_aa.to(dev, torch.int32)[:, rows].permute(1, 0, 2)   # [S, 21, Lm]
    pss = prof_ss.to(dev, torch.int32)[:, rows].permute(1, 0, 2)
    pair_slot = torch.repeat_interleave(torch.arange(S), ps.diff()).to(dev)
    toff = _host_long(pair_toff).to(dev)
    tlen = _host_long(pair_tlen).to(dev)
    Lt = int(tlen.max())
    idx = (toff[:, None] + torch.arange(Lt, device=dev)).clamp(
        max=max(res_aa.numel() - 1, 0))
    return sw_scan_torch(paa, pss, lens.to(dev), pair_slot, res_aa[idx],
                         res_ss[idx], tlen, gap_open, gap_extend)


def _lib():
    from ._build import load
    lib = load("sw").lib
    fn = lib.sw_scores
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, p, p, p, ll, p, p, p, p, p, p, p, ll, i, i,
                       p, p, p]
        fn.restype = ctypes.c_int
    return lib


def sw_scores_pairs(prof_aa: torch.Tensor, prof_ss: torch.Tensor, slot_off,
                    pair_start, res_aa: torch.Tensor, res_ss: torch.Tensor,
                    pair_toff, pair_tlen, gap_open: int = 10,
                    gap_extend: int = 1):
    """Affine SW (score, q_end, t_end) int32 [P] of every (slot, target) pair.

    prof_aa, prof_ss: int32 [21, rows] and res_aa, res_ss: int8 [N] lie on
    the device that runs the scan. slot_off [S + 1] and pair_start [S + 1]
    are read on the host; pair_toff [P] and pair_tlen [P] may lie on either
    device and are used where they are when they lie on the card. Every slot
    must hold at least one row, and on the card every profile entry must lie
    in int8 range. Every launch of the SW kernel goes through this function
    and adds one to `sw_scores_pairs.launches`."""
    dev = res_aa.device
    if dev.type == "cpu":
        return sw_scores_pairs_torch(prof_aa, prof_ss, slot_off, pair_start,
                                     res_aa, res_ss, pair_toff, pair_tlen,
                                     gap_open, gap_extend)
    for name, t, dt in (("prof_aa", prof_aa, torch.int32),
                        ("prof_ss", prof_ss, torch.int32),
                        ("res_aa", res_aa, torch.int8),
                        ("res_ss", res_ss, torch.int8)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device} "
                             f"(contiguous: {t.is_contiguous()})")
    if prof_aa.shape != prof_ss.shape or prof_aa.dim() != 2 \
            or prof_aa.shape[0] != ALPHA or res_aa.shape != res_ss.shape:
        raise ValueError("profiles must be [21, rows], residues equal 1-D")
    so = _host_long(slot_off)
    ps = _host_long(pair_start)
    S = so.numel() - 1
    lens = so.diff()
    counts = ps.diff()
    if S < 0 or ps.numel() != S + 1 or int(ps[0]) != 0 or (counts < 0).any():
        raise ValueError("slot_off and pair_start must be [S + 1] offsets")
    P = int(ps[-1])
    toff, tlen = torch.as_tensor(pair_toff), torch.as_tensor(pair_tlen)
    if toff.shape != (P,) or tlen.shape != (P,):
        raise ValueError("pair_toff and pair_tlen must hold one entry a pair")
    if int(so[0]) != 0 or int(so[-1]) > prof_aa.shape[1] or \
            (S and int(lens.min()) < 1):
        raise ValueError("slot_off must cover non-empty slots of the profiles")
    score = torch.empty(P, dtype=torch.int32, device=dev)
    qend = torch.empty(P, dtype=torch.int32, device=dev)
    tend = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return score, qend, tend
    # what the checks and the plan need to know: the pairs' share is
    # computed where the pairs lie, and the card's share comes home in one
    # trip
    tlen = tlen.to(toff.device)
    pair_facts = torch.stack([toff.min(), (toff.long() + tlen).max(),
                              tlen.min(), tlen.max()]).long()
    used = slice(0, int(so[-1]))
    facts = [torch.stack([*prof_aa[:, used].aminmax(),
                          *prof_ss[:, used].aminmax()]).long()]
    if pair_facts.device == dev:
        facts.append(pair_facts)
    host = torch.cat(facts).tolist()
    aa_min, aa_max, ss_min, ss_max = host[:4]
    toff_min, reach, tlen_min, max_tlen = host[4:] or pair_facts.tolist()
    if toff_min < 0 or tlen_min < 0 or reach > res_aa.numel():
        raise ValueError("pairs reach outside the residue arrays")
    check_profile_range("SW AA profile", aa_min, aa_max)
    check_profile_range("SW 3Di profile", ss_min, ss_max)
    toff = toff.to(dev, torch.long).contiguous()
    tlen = tlen.to(dev, torch.int32).contiguous()
    plan = plan_sw_launch(lens.tolist(), counts.tolist(), max_tlen)
    scratch = torch.empty(max(1, plan["scratch"]), dtype=torch.int32,
                          device=dev)
    slot_off_dev = so.to(dev, torch.int32)
    pair_start_dev = ps.to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().sw_scores(
            int(aa_min != 0 or aa_max != 0), S, plan["nbx"], stream,
            prof_aa.data_ptr(), prof_ss.data_ptr(),
            prof_aa.shape[1], slot_off_dev.data_ptr(),
            pair_start_dev.data_ptr(), res_aa.data_ptr(), res_ss.data_ptr(),
            toff.data_ptr(), tlen.data_ptr(), scratch.data_ptr(),
            plan["scr_stride"], int(gap_open), int(gap_extend),
            score.data_ptr(), qend.data_ptr(), tend.data_ptr())
    if rc != 0:
        raise RuntimeError(f"SW kernel launch failed: CUDA error {rc}")
    sw_scores_pairs.launches += 1
    return score, qend, tend


sw_scores_pairs.launches = 0

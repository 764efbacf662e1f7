"""structurealign: dual-alphabet gapped alignment stage.

Port of `foldseek_tpu/search/align.py` (reference:
src/strucclustutils/structurealign.cpp: alignStructure :37-112, main loop
:318-453): per query build forward + reversed profiles, score every
prefilter candidate on the device, gate by E-value with the reversed-query
score subtraction, recover backtraces on the host for survivors, apply
TM-score / LDDT gates, scale the score by sqrt(lddt * tm) when sorting by
structure bits, sort and emit.

Device mapping: `PairScorer` sends every (query, candidate) pair of the
stage, forward and reversed profile, to one call of `sw_scores_pairs` (the
CUDA kernel on a CUDA device, its plain PyTorch version on the CPU). The
backtraces run in the native host library under a thread pool. TM and LDDT
of the accepted hits run either there (`batch_gates`, float64) or as device
fleets (`ops/gates_device.py`, float32; see DEVICE_GATES_MIN_PAIRS),
dispatched wave by wave so that the device computes one wave's gates while
the host backtraces the next.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..db.panels import resident_panels
from ..db.storage import StructDB
from ..nn.evalue import EvalueComputer
from ..ops import backtrace as bt_ops
from ..ops import lddt as lddt_ops
from ..ops import tmscore as tm_ops
from ..ops.gates_device import GateFleet, m_pad_for
from ..ops.matrices import blosum62, mat3di
from ..ops.sw import QueryProfile
from ..ops.sw_kernels import pack_sw_slots, sw_scores_pairs
from ..utils.hostpar import map_queries
from ..utils.log import logger, record_count, span
from .params import INT_MAX, SearchParams, can_be_covered_mask, has_coverage
from .results import AlnResult, compare_hits, compare_hits_by_structure_bits


class PairScorer:
    """SW score and end positions of every (query, candidate) pair.

    Each query with candidates contributes two slots, its forward and its
    reversed profile (structurealign.cpp:345-347), and each slot is paired
    with every candidate. The whole stage is one `sw_scores_pairs` call and
    one copy back to the host. `per_query[qkey]` holds (fwd score, q_end,
    t_end, reversed score) int64 arrays aligned with the candidate list."""

    def __init__(self, qdb: StructDB, tdb: StructDB, params: SearchParams,
                 prefilter: Dict[int, Sequence[int]], qkey_to_idx,
                 tkey_to_idx, device: torch.device,
                 query_profiles: Optional[Dict[int, object]] = None):
        self.per_query: Dict[int, tuple] = {}
        self.profs: Dict[int, QueryProfile] = {}
        self.rprofs: Dict[int, QueryProfile] = {}
        for qkey in prefilter:
            if query_profiles is not None:
                # prebuilt PSSM profiles (profile and iterative search)
                self.profs[int(qkey)] = query_profiles[int(qkey)]
                continue
            qi = qkey_to_idx[int(qkey)]
            self.profs[int(qkey)] = QueryProfile(
                np.asarray(qdb.get_aa(qi)), np.asarray(qdb.get_ss(qi)),
                comp_bias_correction=params.comp_bias_correction,
                comp_bias_scale=params.comp_bias_correction_scale,
                gap_open=params.gap_open, gap_extend=params.gap_extend,
                with_aa=params.alignment_type != 0)
        scored = [(int(qk), np.fromiter((tkey_to_idx[int(tk)] for tk in c),
                                        np.int64, len(c)))
                  for qk, c in prefilter.items() if len(c)]
        if not scored:
            return
        slots_aa, slots_ss, counts, tids = [], [], [], []
        for qk, ti in scored:
            prof = self.profs[qk]
            rprof = self.rprofs[qk] = prof.reversed()
            slots_aa += [prof.prof_aa, rprof.prof_aa]
            slots_ss += [prof.prof_ss, rprof.prof_ss]
            counts += [len(ti), len(ti)]
            tids += [ti, ti]
        paa, pss, slot_off = pack_sw_slots(slots_aa, slots_ss)
        pair_start = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=pair_start[1:])
        panels = resident_panels(tdb, device)
        offs = panels.offsets
        tids = np.concatenate(tids)
        res_aa, res_ss = panels.residues()
        out = sw_scores_pairs(
            torch.from_numpy(paa).to(device), torch.from_numpy(pss).to(device),
            slot_off, pair_start, res_aa, res_ss, offs[tids],
            offs[tids + 1] - offs[tids], params.gap_open, params.gap_extend)
        score, qend, tend = torch.stack(out).cpu().numpy().astype(np.int64)
        for s, (qk, ti) in enumerate(scored):
            fwd = slice(pair_start[2 * s], pair_start[2 * s + 1])
            rev = slice(pair_start[2 * s + 1], pair_start[2 * s + 2])
            self.per_query[qk] = (score[fwd], qend[fwd], tend[fwd], score[rev])


# Candidate pairs of a stage from which a card takes the TM/LDDT gates as
# device fleets by default. Measured on an NVIDIA H100 80GB HBM3, 700.00 W,
# with 8 host cores (chip_smoke.py, 16 queries x 100,000 targets, the fleet
# alone from dispatch to readback beside the host's batch_gates, three runs
# on three machines): 16,000 hits 0.47 / 0.59 / 0.78 s against 0.74 / 1.16 /
# 1.22 s; 4,000 hits 0.13 / 0.34 / 0.23 s against 0.19 / 0.27 / 0.30 s; 1,000
# hits 0.13 / 0.18 / 0.22 s against 0.06 / 0.08 / 0.16 s. The fleet wins at
# 16,000, loses at 1,000 and 4,000 goes either way, so the threshold lies
# between the two. End to end the two sides lie inside the host's spread.
# FOLDSEEK_TPU_DEVICE_GATES=1 forces the fleets on any device and size, =0
# forces the host.
DEVICE_GATES_MIN_PAIRS = 8192


def align_all(qdb: StructDB, tdb: StructDB,
              prefilter: Dict[int, Sequence[int]], params: SearchParams,
              device: torch.device,
              same_db: bool = False,
              query_profiles: Optional[Dict[int, object]] = None,
              db_residues: Optional[int] = None,
              gate_pairs: Optional[int] = None
              ) -> Dict[int, List[AlnResult]]:
    """Run the alignment stage for every query.

    prefilter: query key -> ordered candidate target keys.
    query_profiles: optional prebuilt PSSM profiles (profile and iterative
    search).
    db_residues, gate_pairs: where `tdb` is one rank's rows of a DB, that
    DB's residues (the E-values' search space) and the pairs of the whole
    stage (which choose between host gates and gate fleets); by default
    `tdb`'s and this call's.
    Returns query key -> sorted AlnResult list."""
    device = torch.device(device)
    n_pairs = sum(len(v) for v in prefilter.values())
    record_count("align_pairs", n_pairs)
    with span("align.setup"):
        ev = EvalueComputer(tdb.total_residues if db_residues is None
                            else db_residues)
        tkey_to_idx = tdb.key_to_index()
        qkey_to_idx = qdb.key_to_index()
    with span("sw_scoring"):
        scorer = PairScorer(qdb, tdb, params, prefilter, qkey_to_idx,
                            tkey_to_idx, device, query_profiles=query_profiles)

    need_tm = params.tmscore_threshold > 0 or params.sort_by_structure_bits
    need_lddt = params.lddt_threshold > 0 or params.sort_by_structure_bits
    need_ca = (need_tm or need_lddt) and qdb.ca is not None and tdb.ca is not None
    if (need_tm or need_lddt) and not need_ca:
        logger.warning("C-alpha data missing; disabling structure bits/TM/LDDT gates")
        need_tm = need_lddt = False
        params.sort_by_structure_bits = False

    # TM/LDDT as pure scoring inputs (thresholds 0, no alt-ali): the
    # accept/reject loop does not depend on their values, so each query's
    # accepted hits go to one batched native call (the same C routines as
    # the per-hit path, so the results are bit-identical)
    can_defer = ((need_tm or need_lddt)
                 and params.tmscore_threshold <= 0
                 and params.lddt_threshold <= 0
                 and params.alt_alignment == 0)
    gate_env = os.environ.get("FOLDSEEK_TPU_DEVICE_GATES", "")
    if gate_env == "1":
        gate_min = 0
    elif gate_env == "0" or device.type != "cuda":
        gate_min = None   # the host's batch_gates, whatever the size
    else:
        gate_min = DEVICE_GATES_MIN_PAIRS
    defer_gates = (can_defer and gate_min is not None
                   and (n_pairs if gate_pairs is None else gate_pairs)
                   >= gate_min)
    if defer_gates:
        gates_mode = "device"
    else:
        gates_mode = "host" if can_defer and native_ready() else "inline"

    tracebacks = []   # each query's pairs given a traceback

    def one(qkey_cands):
        qkey, cand_keys = qkey_cands
        qi = qkey_to_idx[int(qkey)]
        results, n_tb = align_query(
            qi, qdb, tdb, cand_keys, params, ev, scorer, tkey_to_idx,
            need_tm=need_tm, need_lddt=need_lddt, same_db=same_db,
            gates_mode=gates_mode)
        tracebacks.append(n_tb)
        return int(qkey), results

    if defer_gates:
        # waves: each wave's TM/LDDT fleets are dispatched as soon as its
        # backtraces exist, so the device computes wave k while the host
        # runs wave k + 1's per-hit loop; the drain at the end then mostly
        # finds finished work
        items = list(prefilter.items())
        n_waves = min(4, max(1, len(items) // 4))
        per = -(-len(items) // n_waves)
        out = {}
        in_flight = []
        with span("host_loop"):
            for w0 in range(0, len(items), per):
                wave_out = dict(map_queries(one, items[w0:w0 + per]))
                out.update(wave_out)
                with span("gates.dispatch"):
                    in_flight.append(_device_gates_dispatch(
                        qdb, tdb, wave_out, params, qkey_to_idx,
                        tkey_to_idx, need_tm, need_lddt, device))
        _count_hits(tracebacks, out)
        with span("gates_drain"):
            for fleets in in_flight:
                _device_gates_finish(fleets, params, need_tm, need_lddt)
        key = (compare_hits_by_structure_bits
               if params.sort_by_structure_bits else compare_hits)
        for rs in out.values():
            rs.sort(key=key)
        return out
    with span("host_loop"):
        out = dict(map_queries(one, prefilter.items()))
    _count_hits(tracebacks, out)
    return out


def _count_hits(tracebacks, out):
    """One number each for the call: the pairs given a traceback and the
    records `align_query` returned (before any gate fleet)."""
    record_count("align_backtraces", sum(tracebacks))
    record_count("align_hits", sum(len(rs) for rs in out.values()))


def _device_gates_dispatch(qdb, tdb, results, params, qkey_to_idx,
                           tkey_to_idx, need_tm, need_lddt, device,
                           check_every: int = -1):
    """Dispatch fused batched TM + LDDT (ops/gates_device) over every
    accepted hit of `results`, with device-side coordinate gather from the
    resident target C-alpha panel. One fleet per bucket of alignment
    lengths; returns the fleets in flight, so that the caller can go on with
    host work before draining them with `_device_gates_finish`. Tiny
    alignments (< 8 columns) take the host path at once: degenerate
    superpositions are where float32 and the reference's float64 could
    drift. `check_every` is `GateFleet.dispatch`'s (-1: the device's
    default)."""
    lddt_ctx_cache: Dict[int, tuple] = {}
    buckets: Dict[int, list] = {}  # m_pad -> [(res, qkey, ti, norm, m)]
    for qkey, rs in results.items():
        qi = qkey_to_idx[int(qkey)]
        q_ca = qdb.get_ca(qi)
        q_len = qdb.entry_len(qi)
        if need_lddt and int(qkey) not in lddt_ctx_cache:
            lddt_ctx_cache[int(qkey)] = lddt_ops.lddt_query_context(q_ca)
        ctx = lddt_ctx_cache.get(int(qkey))
        for res in rs:
            ti = tkey_to_idx[res.db_key]
            m = res.backtrace.count("M")
            if m < 8:
                _host_gates_one(res, q_ca, tdb.get_ca(ti), ctx, params,
                                q_len, tdb.entry_len(ti), need_tm, need_lddt)
                continue
            norm = tm_ops.normalization(
                params.tmscore_threshold_mode,
                min(res.q_end - res.q_start, res.t_end - res.t_start),
                q_len, res.t_len)
            buckets.setdefault(m_pad_for(m), []).append(
                (res, int(qkey), ti, norm, m))
    if not buckets:
        return []

    # query coords + per-residue LDDT degree, concatenated per wave (small)
    q_row: Dict[int, int] = {}
    qc_list, qd_list = [], []
    rows = 0
    for qkey in results:
        qi = qkey_to_idx[int(qkey)]
        q_row[int(qkey)] = rows
        qc = np.asarray(qdb.get_ca(qi), dtype=np.float32)
        qc_list.append(qc)
        if need_lddt and int(qkey) in lddt_ctx_cache:
            qd_list.append(lddt_ctx_cache[int(qkey)][1])
        else:
            qd_list.append(np.zeros(len(qc), np.float32))
        rows += len(qc)
    q_coords = torch.from_numpy(np.concatenate(qc_list)).to(device)
    q_deg = torch.from_numpy(
        np.concatenate(qd_list).astype(np.float32)).to(device)

    # target panel: the whole DB's resident one, or the union of the targets
    # this wave needs when the DB's does not fit the device budget
    t_panel = resident_panels(tdb, device).ca()
    if t_panel is not None:
        t_base = np.asarray(tdb.offsets[:-1], dtype=np.int64)
    else:
        needed = sorted({ti for items in buckets.values()
                         for (_, _, ti, _, _) in items})
        t_base = np.zeros(tdb.size, dtype=np.int64)
        tc_list = []
        rows = 0
        for ti in needed:
            t_base[ti] = rows
            tc = np.asarray(tdb.get_ca(ti), dtype=np.float32)
            tc_list.append(tc)
            rows += len(tc)
        t_panel = torch.from_numpy(np.concatenate(tc_list)).to(device)

    # gather indices of a whole bucket from one vectorised pass over the
    # joined backtrace strings
    fleets = []
    for m_pad, items in sorted(buckets.items()):
        fleet = GateFleet(m_pad, len(items), need_tm, need_lddt)
        P = len(items)
        joined = "".join(it[0].backtrace for it in items).encode("ascii")
        arr = np.frombuffer(joined, dtype=np.uint8)
        lens = np.fromiter((len(it[0].backtrace) for it in items),
                           dtype=np.int64, count=P)
        off = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        seg = np.repeat(np.arange(P, dtype=np.int64), lens)
        qstep = arr != ord("D")
        tstep = arr != ord("I")
        mmask = arr == ord("M")
        # per-segment exclusive cumsums via global-cumsum rebasing
        cq = np.cumsum(qstep)
        ct = np.cumsum(tstep)
        cm = np.cumsum(mmask)
        base = off[:-1]
        lq_excl = (cq - qstep) - (cq[base] - qstep[base])[seg]
        lt_excl = (ct - tstep) - (ct[base] - tstep[base])[seg]
        lm_excl = (cm - mmask) - (cm[base] - mmask[base])[seg]
        q_starts = np.fromiter((it[0].q_start for it in items),
                               dtype=np.int64, count=P)
        t_starts = np.fromiter((it[0].t_start for it in items),
                               dtype=np.int64, count=P)
        q_rows = np.fromiter((q_row[it[1]] for it in items),
                             dtype=np.int64, count=P)
        t_bases = np.fromiter((t_base[it[2]] for it in items),
                              dtype=np.int64, count=P)
        rows = seg[mmask]
        cols = lm_excl[mmask]
        fleet.qabs[rows, cols] = (q_rows[rows] + q_starts[rows]
                                  + lq_excl[mmask])
        fleet.tabs[rows, cols] = (t_bases[rows] + t_starts[rows]
                                  + lt_excl[mmask])
        fleet.m_len[:] = np.fromiter((it[4] for it in items),
                                     dtype=np.int32, count=P)
        fleet.norm[:] = np.fromiter((it[3] for it in items),
                                    dtype=np.int32, count=P)
        fleet.dispatch(t_panel, q_coords, q_deg, check_every)
        fleets.append((items, fleet))
    return fleets


def _device_gates_finish(fleets, params, need_tm, need_lddt):
    """Wait for each fleet in flight and apply TM / LDDT and the
    structure-bit score scaling."""
    for items, fleet in fleets:
        tm, lddt, _ = fleet.result()
        for j, (res, *_rest) in enumerate(items):
            if need_tm:
                res.tm = float(tm[j])
            if need_lddt:
                res.lddt = float(lddt[j])
            if params.sort_by_structure_bits and need_tm and need_lddt:
                # degenerate superpositions (toy/colinear coords) can yield
                # NaN TM; finite-positive guard keeps parity elsewhere
                f = res.lddt * res.tm
                res.score = int(res.score * math.sqrt(f)) if f > 0 else 0


def _host_gates_one(res, q_ca, t_ca, lddt_ctx, params, q_len, t_len,
                    need_tm, need_lddt):
    """Host-native TM/LDDT for one survivor (the phase-B fallback)."""
    if not res.backtrace:  # block-align failure row: TM/LDDT fixed at 0
        return
    if need_tm:
        norm_len = tm_ops.normalization(
            params.tmscore_threshold_mode,
            min(res.q_end - res.q_start, res.t_end - res.t_start),
            q_len, t_len)
        tmres = tm_ops.compute_tm_score(q_ca, t_ca, res.q_start, res.t_start,
                                        res.backtrace, norm_len)
        res.tm = tmres.tmscore
        res.u = tmres.u
        res.t = tmres.t
    if need_lddt:
        lr = lddt_ops.compute_lddt(q_ca, t_ca, res.q_start, res.t_start,
                                   res.backtrace, q_ctx=lddt_ctx)
        res.lddt = lr.avg_lddt
    if params.sort_by_structure_bits and need_tm and need_lddt:
        f = res.lddt * res.tm
        res.score = int(res.score * math.sqrt(f)) if f > 0 else 0


def _pre_gate_mask(params, q_len, t_lens, qend, tend, ev_fwd, ev_corr):
    """Vectorized pre-backtrace gates — element-identical to the scalar
    loop's first four checks (canBeCovered, endpoint coverage estimate,
    forward + corrected E-value)."""
    ok = can_be_covered_mask(params.cov_thr, params.cov_mode, q_len, t_lens)
    if params.cov_thr > 0.0:
        q_cov0 = np.minimum(1.0, (qend + 1) / q_len)
        t_cov0 = np.minimum(1.0, (tend + 1) / t_lens)
        if params.cov_mode == 0:
            ok &= (q_cov0 >= params.cov_thr) & (t_cov0 >= params.cov_thr)
        elif params.cov_mode == 1:
            ok &= t_cov0 >= params.cov_thr
        elif params.cov_mode == 2:
            ok &= q_cov0 >= params.cov_thr
    ok &= (ev_fwd <= params.evalue_thr) & (ev_corr <= params.evalue_thr)
    return ok


# sentinel: the block-aligner search could not reproduce the forward score
# for this hit — the reference emits its failure row instead of falling
# back (structurealign.cpp:78-89; the `align.score1 == UINT32_MAX` check
# reads the pre-call struct and is dead code in the default build)
BLOCK_FAIL = object()


def use_block_aligner(prof) -> bool:
    """True when the backtrace of this query takes the reference's default
    block-aligner path (alignStartPosBacktraceBlock): a plain sequence query
    and the native host library loaded. Profile queries (PSSMQueryProfile)
    take the alignStartPosBacktrace reverse-SW path
    (structurealign.cpp:77+92); without the library the backtraces fall back
    to `recover_alignment` in Python."""
    if type(prof) is not QueryProfile:
        return False
    lib = native.get_lib()
    return lib is not None and hasattr(lib, "batch_recover_block")


def native_ready() -> bool:
    """True when the native host library (block-aligner backtraces, batched
    TM/LDDT gates) built and loaded."""
    return native.get_lib() is not None


def _block_mats(prof):
    """(mat_aa, mat_ss) int8 21x21 exactly as the block path receives them
    (subMatAA/subMat3Di->subMatrix, StructureSmithWaterman.cpp:428-446);
    3Di-only mode zeroes the AA matrix (structurealign.cpp:264-265)."""
    maa = blosum62().scores.astype(np.int8)
    if not getattr(prof, "_with_aa", True):
        maa = np.zeros_like(maa)
    return maa, mat3di().scores.astype(np.int8)


def _block_tracebacks(prof, db_aa, db_ss, t_offs, t_ends, scores, q_ends):
    """Run batch_recover_block over hit arrays; list of Traceback /
    BLOCK_FAIL / None (native unavailable)."""
    fprof = getattr(prof, "_flipped_cache", None)
    if fprof is None:
        fprof = prof.flipped()
        prof._flipped_cache = fprof
    bias_rev = (fprof.bias_aa.astype(np.int16)
                + fprof.bias_ss.astype(np.int16))
    maa, mss = _block_mats(prof)
    res = native.batch_recover_block(
        fprof.q_aa, fprof.q_ss, bias_rev, maa, mss, db_aa, db_ss,
        t_offs, t_ends, scores, q_ends, prof.gap_open, prof.gap_extend)
    if res is None:
        return None
    q_start, t_start, ident, ops = res
    out = []
    for j in range(len(ops)):
        if ops[j] == "BLOCK_FAIL":
            out.append(BLOCK_FAIL)
        else:
            out.append(bt_ops.Traceback(
                q_start=int(q_start[j]), t_start=int(t_start[j]),
                backtrace=ops[j], identical_aa=int(ident[j])))
    return out


def _block_traceback_one(prof, t_aa, t_ss, score, q_end, t_end):
    """Single-pair block backtrace (alt-alignment / non-default-budget
    paths); Traceback, BLOCK_FAIL, or None when native is unavailable."""
    t_aa = np.ascontiguousarray(t_aa, dtype=np.int8)
    t_ss = np.ascontiguousarray(t_ss, dtype=np.int8)
    res = _block_tracebacks(
        prof, t_aa, t_ss,
        np.zeros(1, np.int64), np.asarray([t_end], np.int32),
        np.asarray([score], np.int32), np.asarray([q_end], np.int32))
    return None if res is None else res[0]


def _batch_tracebacks(prof, tdb, tids, params, fwd, qend, tend, pre_ok):
    """ci -> Traceback (or BLOCK_FAIL) for every candidate the serial loop
    would backtrace, recovered in one native call: the block aligner for a
    sequence query, reverse SW + banded traceback for a profile query. Empty
    when batching can't reproduce the loop exactly (non-default
    accept/reject budgets: an early break could skip candidates) or the
    native lib is absent."""
    if (params.max_accept < INT_MAX or params.max_rejected < INT_MAX
            or len(tids) == 0 or not native_ready()):
        return {}
    surv = np.nonzero(pre_ok)[0]
    if not len(surv):
        return {}
    offs = np.asarray(tdb.offsets)
    if use_block_aligner(prof):
        with span("align.backtraces"):
            res = _block_tracebacks(
                prof, np.asarray(tdb.aa), np.asarray(tdb.ss),
                offs[tids[surv]], tend[surv], fwd[surv], qend[surv])
        if res is None:
            return {}
        return {int(ci): res[j] for j, ci in enumerate(surv)}
    if type(prof) is QueryProfile:
        return {}   # a library without the block aligner: per-hit Python
    fprof = getattr(prof, "_flipped_cache", None)
    if fprof is None:
        fprof = prof.flipped()
        prof._flipped_cache = fprof
    with span("align.backtraces"):
        res = native.batch_recover(
            fprof.prof_aa, fprof.prof_ss, prof.prof_aa, prof.prof_ss,
            np.asarray(prof.q_aa), np.asarray(tdb.aa), np.asarray(tdb.ss),
            offs[tids[surv]], tend[surv], fwd[surv], qend[surv],
            prof.gap_open, prof.gap_extend)
    if res is None:
        return {}
    q_start, t_start, ident, ops = res
    return {int(ci): bt_ops.Traceback(
                q_start=int(q_start[j]), t_start=int(t_start[j]),
                backtrace=ops[j], identical_aa=int(ident[j]))
            for j, ci in enumerate(surv) if ops[j] is not None}


def align_query(qi: int, qdb: StructDB, tdb: StructDB,
                cand_keys: Sequence[int], params: SearchParams,
                ev: EvalueComputer, scorer: PairScorer, tkey_to_idx,
                need_tm: bool, need_lddt: bool, same_db: bool,
                gates_mode: str = "inline") -> Tuple[List[AlnResult], int]:
    """One query's records and the number of its pairs given a traceback.
    Spans (with "_cpu" in align_all's pool): `align.query` the whole,
    `align.backtraces` the batched tracebacks, `align.hits` the loop over
    the candidates, `align.gates` the host's batched TM/LDDT."""
    with span("align.query"):
        return _align_query(qi, qdb, tdb, cand_keys, params, ev, scorer,
                            tkey_to_idx, need_tm, need_lddt, same_db,
                            gates_mode)


def _align_query(qi, qdb, tdb, cand_keys, params, ev, scorer, tkey_to_idx,
                 need_tm, need_lddt, same_db, gates_mode):
    q_aa = qdb.get_aa(qi)
    q_ss = qdb.get_ss(qi)
    q_len = len(q_aa)
    qkey = int(qdb.keys[qi])
    prof = scorer.profs[qkey]
    lam, mu = ev.predict_lambda_mu(q_ss)
    q_ca = qdb.get_ca(qi) if need_tm or need_lddt else None
    lddt_ctx = lddt_ops.lddt_query_context(q_ca) if need_lddt else None

    tids = np.array([tkey_to_idx[int(k)] for k in cand_keys], dtype=np.int64)
    if len(tids) == 0:
        return [], 0

    fwd, qend, tend, rev = scorer.per_query[qkey]
    scores = fwd - rev
    ev_fwd = ev.evalue_corr_batch(fwd, lam, mu)
    ev_corr = ev.evalue_corr_batch(scores, lam, mu)

    offs = np.asarray(tdb.offsets)
    t_lens_arr = offs[tids + 1] - offs[tids]
    # vectorized pre-backtrace gates (canBeCovered + endpoint coverage +
    # both E-values) — element-identical to the scalar checks
    pre_ok = _pre_gate_mask(params, q_len, t_lens_arr, qend, tend,
                            ev_fwd, ev_corr)

    # batched native start+traceback recovery: with the default INT_MAX
    # accept/reject budgets no candidate is skipped by an early break, so
    # every candidate passing the pre-backtrace gates gets its traceback
    # from ONE native call (vs 2 ctypes round trips per hit)
    pre_tb = _batch_tracebacks(prof, tdb, tids, params, fwd, qend, tend,
                               pre_ok)

    qkey_int = int(qdb.keys[qi])
    identity_ok = same_db or params.include_identity
    pre_ok_l = pre_ok.tolist()
    scores_l = scores.tolist()
    ev_corr_l = ev_corr.tolist()
    qend_l = qend.tolist()
    tend_l = tend.tolist()
    t_lens_l = t_lens_arr.tolist()
    results: List[AlnResult] = []
    passed = 0
    rejected = 0
    per_hit_tb = 0
    with span("align.hits"):
        for ci in range(len(tids)):
            if passed >= params.max_accept or rejected >= params.max_rejected:
                break
            tkey = int(cand_keys[ci])
            t_len = t_lens_l[ci]
            # reference: isIdentity = (queryId == targetId && (includeIdentity || sameDB))
            is_identity = (qkey_int == tkey) and identity_ok
            if not pre_ok_l[ci]:
                rejected += 1
                continue
            ti = tids[ci]

            tb = pre_tb.get(ci)
            if tb is None:
                per_hit_tb += 1
                if use_block_aligner(prof):
                    tb = _block_traceback_one(
                        prof, np.asarray(tdb.get_aa(ti)),
                        np.asarray(tdb.get_ss(ti)),
                        int(fwd[ci]), int(qend[ci]), int(tend[ci]))
                if tb is None:
                    try:
                        tb = bt_ops.recover_alignment(
                            prof, np.asarray(tdb.get_aa(ti)),
                            np.asarray(tdb.get_ss(ti)),
                            int(fwd[ci]), int(qend[ci]), int(tend[ci]))
                    except RuntimeError as e:
                        logger.warning("backtrace failed for query %d target "
                                       "%d: %s", qi, ti, e)
                        rejected += 1
                        continue
            if tb is BLOCK_FAIL:
                # the reference's block-align failure row: score1 = UINT32_MAX
                # propagates the alignScoreEndPos struct unchanged (the dead
                # `align.score1 == UINT32_MAX` check never triggers a fallback),
                # so qStart/dbStart stay -1, the backtrace stays empty, covs
                # keep their start-0 estimates, seqId is 0 and alnLength =
                # computeAlnLength(-1, qEnd, -1, dbEnd)
                # (structurealign.cpp:78-108, Matcher.cpp:155-157)
                aln_len = max(qend_l[ci] + 1, tend_l[ci] + 1) + 1
                res = AlnResult(
                    db_key=tkey, score=scores_l[ci], seq_id=0.0,
                    evalue=ev_corr_l[ci],
                    q_start=-1, q_end=qend_l[ci], q_len=q_len,
                    t_start=-1, t_end=tend_l[ci], t_len=t_len,
                    backtrace="", qcov=min(1.0, (qend_l[ci] + 1) / q_len),
                    tcov=min(1.0, (tend_l[ci] + 1) / t_len),
                    aln_length=aln_len, identical=0)
                ok = is_identity or (
                    res.evalue <= params.evalue_thr
                    and res.seq_id >= params.seq_id_thr
                    and has_coverage(params.cov_thr, params.cov_mode, res.qcov,
                                     res.tcov)
                    and aln_len >= params.aln_len_thr)
                if not ok:
                    rejected += 1
                    continue
                if need_tm or need_lddt:
                    # no aligned pairs: TM/LDDT degenerate to 0 (the gates below
                    # then drop the row when a positive threshold is active)
                    res.tm = 0.0
                    res.lddt = 0.0
                    if params.tmscore_threshold > 0 or params.lddt_threshold > 0:
                        continue
                    if params.sort_by_structure_bits and need_tm and need_lddt:
                        res.score = 0
                results.append(res)
                passed += 1
                rejected = 0
                continue

            aln_len = len(tb.backtrace)
            seq_id = tb.identical_aa / aln_len if aln_len else 0.0
            qcov = (qend_l[ci] - tb.q_start + 1) / q_len
            tcov = (tend_l[ci] - tb.t_start + 1) / t_len
            res = AlnResult(
                db_key=tkey, score=scores_l[ci], seq_id=float(np.float32(seq_id)),
                evalue=ev_corr_l[ci],
                q_start=int(tb.q_start), q_end=qend_l[ci], q_len=q_len,
                t_start=int(tb.t_start), t_end=tend_l[ci], t_len=t_len,
                backtrace=tb.backtrace, qcov=qcov, tcov=tcov,
                aln_length=aln_len, identical=tb.identical_aa)

            ok = is_identity or (
                res.evalue <= params.evalue_thr
                and res.seq_id >= params.seq_id_thr
                and has_coverage(params.cov_thr, params.cov_mode, qcov, tcov)
                and aln_len >= params.aln_len_thr)
            if not ok:
                rejected += 1
                continue

            if (need_tm or need_lddt) and gates_mode == "inline":
                t_ca = tdb.get_ca(ti)
                if need_tm:
                    norm_len = tm_ops.normalization(
                        params.tmscore_threshold_mode,
                        min(res.q_end - res.q_start, res.t_end - res.t_start),
                        q_len, t_len)
                    tmres = tm_ops.compute_tm_score(q_ca, t_ca, res.q_start, res.t_start,
                                                    res.backtrace, norm_len)
                    if tmres.tmscore < params.tmscore_threshold:
                        continue
                    res.tm = tmres.tmscore
                    res.u = tmres.u
                    res.t = tmres.t
                if need_lddt:
                    lr = lddt_ops.compute_lddt(q_ca, t_ca, res.q_start, res.t_start,
                                               res.backtrace, q_ctx=lddt_ctx)
                    if lr.avg_lddt < params.lddt_threshold:
                        continue
                    res.lddt = lr.avg_lddt
                if params.sort_by_structure_bits and need_tm and need_lddt:
                    # degenerate superpositions (toy/colinear coords) can yield
                    # NaN TM; finite-positive guard keeps parity elsewhere
                    f = res.lddt * res.tm
                    res.score = int(res.score * math.sqrt(f)) if f > 0 else 0

            results.append(res)
            passed += 1
            rejected = 0

            # alternative alignments: X-mask the aligned target region and
            # re-align (structurealign.cpp:115-138, computeAlternativeAlignment)
            if params.alt_alignment > 0:
                from ..ops.sw import sw_score_endpos_np
                t_aa = tdb.get_aa(ti)
                t_ss = tdb.get_ss(ti)
                t_aa_m = np.asarray(t_aa).copy()
                t_ss_m = np.asarray(t_ss).copy()
                prev = res
                rprof = scorer.rprofs[qkey]
                for _ in range(params.alt_alignment):
                    t_aa_m[prev.t_start:prev.t_end] = 20
                    t_ss_m[prev.t_start:prev.t_end] = 20
                    a_fwd, a_qe, a_te = sw_score_endpos_np(
                        *prof.padded(prof.L), t_aa_m, t_ss_m,
                        gap_open=prof.gap_open, gap_extend=prof.gap_extend)
                    a_rev, _, _ = sw_score_endpos_np(
                        *rprof.padded(prof.L), t_aa_m, t_ss_m,
                        gap_open=prof.gap_open, gap_extend=prof.gap_extend)
                    a_score = int(a_fwd) - int(a_rev)
                    a_ev = ev.evalue_corr(a_score, lam, mu)
                    if (ev.evalue_corr(a_fwd, lam, mu) > params.evalue_thr
                            or a_ev > params.evalue_thr):
                        break
                    a_tb = (_block_traceback_one(prof, t_aa_m, t_ss_m,
                                                 int(a_fwd), a_qe, a_te)
                            if use_block_aligner(prof) else None)
                    if a_tb is BLOCK_FAIL:
                        break  # reference would emit a -1/-1 empty-backtrace
                        # alt row (computeAlternativeAlignment -> the same dead
                        # fallback check); its X-masking of [-1, dbEnd) is UB,
                        # so the alt chain stops here instead
                    if a_tb is None:
                        try:
                            a_tb = bt_ops.recover_alignment(
                                prof, t_aa_m, t_ss_m, int(a_fwd), a_qe, a_te)
                        except RuntimeError:
                            break
                    a_len = len(a_tb.backtrace)
                    a_seqid = a_tb.identical_aa / a_len if a_len else 0.0
                    a_qcov = (a_qe - a_tb.q_start + 1) / q_len
                    a_tcov = (a_te - a_tb.t_start + 1) / t_len
                    alt = AlnResult(
                        db_key=tkey, score=a_score,
                        seq_id=float(np.float32(a_seqid)), evalue=float(a_ev),
                        q_start=a_tb.q_start, q_end=a_qe, q_len=q_len,
                        t_start=a_tb.t_start, t_end=a_te, t_len=t_len,
                        backtrace=a_tb.backtrace, qcov=a_qcov, tcov=a_tcov,
                        aln_length=a_len, identical=a_tb.identical_aa)
                    ok_alt = (alt.evalue <= params.evalue_thr
                              and alt.seq_id >= params.seq_id_thr
                              and alt.aln_length >= params.aln_len_thr
                              and has_coverage(params.cov_thr, params.cov_mode,
                                               a_qcov, a_tcov))
                    if not ok_alt:
                        break
                    results.append(alt)
                    prev = alt

    n_tb = len(pre_tb) + per_hit_tb
    if gates_mode == "device":
        # the caller sorts after the fleets' TM/LDDT scaling
        return results, n_tb
    if gates_mode == "host":
        with span("align.gates"):
            _host_gates_batch(results, tdb, tkey_to_idx, params, q_len, q_ca,
                              lddt_ctx, need_tm, need_lddt)
    if params.sort_by_structure_bits:
        results.sort(key=compare_hits_by_structure_bits)
    else:
        results.sort(key=compare_hits)
    return results, n_tb


def _host_gates_batch(results, tdb, tkey_to_idx, params, q_len, q_ca,
                      lddt_ctx, need_tm, need_lddt):
    """TM/LDDT for one query's accepted hits in ONE native call
    (native batch_gates — the same C routines as the per-hit path, so the
    scores are bit-identical; only the per-hit python marshalling goes)."""
    results = [r for r in results if r.backtrace]  # skip block-failure rows
    if not results:
        return
    t_cas, qs, ts, bts, nls = [], [], [], [], []
    for res in results:
        ti = tkey_to_idx[res.db_key]
        t_cas.append(tdb.get_ca(ti))
        qs.append(res.q_start)
        ts.append(res.t_start)
        bts.append(res.backtrace)
        nls.append(tm_ops.normalization(
            params.tmscore_threshold_mode,
            min(res.q_end - res.q_start, res.t_end - res.t_start),
            q_len, res.t_len) if need_tm else 0)
    out = native.batch_gates(
        q_ca, lddt_ctx[1] if lddt_ctx is not None else None,
        t_cas, qs, ts, bts, nls, need_tm, need_lddt)
    if out is None:  # library vanished mid-run: per-hit fallback
        for res in results:
            ti = tkey_to_idx[res.db_key]
            _host_gates_one(res, q_ca, tdb.get_ca(ti), lddt_ctx, params,
                            q_len, res.t_len, need_tm, need_lddt)
        return
    for j, res in enumerate(results):
        if need_tm:
            res.tm = float(out["tm"][j])
            res.u = out["u"][j]
            res.t = out["t"][j]
        if need_lddt:
            res.lddt = float(out["lddt"][j])
        if params.sort_by_structure_bits and need_tm and need_lddt:
            f = res.lddt * res.tm
            res.score = int(res.score * math.sqrt(f)) if f > 0 else 0

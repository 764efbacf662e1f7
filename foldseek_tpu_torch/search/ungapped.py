"""Ungapped prefilter stage (PREF_MODE_UNGAPPED), the `--gpu 1` prefilter,
and `--prefilter-mode 3` (PREF_MODE_UNGAPPED_AND_GAPPED).

Port of `foldseek_tpu/search/ungapped.py`. Reference semantics
(lib/mmseqs/src/prefiltering/ungappedprefilter.cpp):
  * single alphabet: 3Di seed matrix at bit scale 2.0, scoreBias 0 (:533)
  * query composition bias at scale 0.15 in the foldseek search workflow
    (src/workflow/StructureSearch.cpp:101)
  * score = best ungapped diagonal, byte-saturated at 255 (StripedSW
    ungapped_alignment, StripedSmithWaterman.cpp:1817-1875)
  * keep score > min_ungapped_score (15), top max_seqs by (score desc, key asc)

Device path: all queries form one ragged profile stack and every length
bucket of the target DB is scanned by one gapless-kernel launch over its
transposed int8 panel. Queries of any length share the stack (the kernel
has no row limit). When the panels exceed the device-memory budget, buckets
stream through the device in splits and per-query candidate lists are
merged across splits (the reference's TARGET_DB_SPLIT,
Prefiltering.cpp:289-381).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..db.panels import TorchPanelSet, resident_panels
from ..db.storage import StructDB
from ..device import panel_budget
from ..nn.evalue import EvalueComputer
from ..ops.gapless import (gapless_scores_batch, gapless_topk_batch,
                           pack_profiles_batch)
from ..ops.matrices import mat3di
from ..ops.sw import calc_comp_bias
from ..ops.sw_kernels import pack_sw_slots, sw_scores_pairs
from ..utils.log import logger, span
from .params import SearchParams, can_be_covered_mask
from .results import AlnResult

MIN_DIAG_SCORE = 15
PREFILTER_BIAS_SCALE = 0.15
BYTE_CAP = 255
# queries per kernel launch: bounds the [q, rows] score block of a piece
MAX_STACK_QUERIES = 512
# device top-k (only [q, k] candidates come home) for pieces of at least
# this many panel rows; smaller pieces bring their full score rows home
DEVICE_TOPK_MIN_ROWS = 16384


def make_query_profile(q_ss: np.ndarray):
    """[21, L] single-alphabet 3Di prefilter profile with composition bias
    + byte bias (the running-score saturation offset)."""
    m3 = mat3di(2.0, 0.0)
    q_ss = np.asarray(q_ss)
    bias = calc_comp_bias(q_ss, m3.scores, m3.p_back, PREFILTER_BIAS_SCALE)
    prof = m3.scores[:, q_ss].astype(np.float32) + bias[None, :].astype(np.float32)
    byte_bias = abs(int(m3.scores.min())) + abs(min(int(bias.min()), 0))
    return prof, byte_bias


def make_profile_stacks(profs, byte_biases, device: torch.device):
    """Ragged profile stacks of at most MAX_STACK_QUERIES queries, on
    `device`: [(query indices, prof, q_off, caps)]."""
    stacks = []
    for i in range(0, len(profs), MAX_STACK_QUERIES):
        idx = list(range(i, min(i + MAX_STACK_QUERIES, len(profs))))
        prof, q_off, caps = pack_profiles_batch(
            [profs[g] for g in idx], [BYTE_CAP - byte_biases[g] for g in idx])
        stacks.append((idx, *(torch.from_numpy(a).to(device)
                              for a in (prof, q_off, caps))))
    return stacks


class UngappedPrefilter:
    """Bucketed target panels on `device`, scanned for query batches."""

    def __init__(self, tdb: StructDB, device: torch.device,
                 budget_bytes: Optional[int] = None,
                 panels: Optional[TorchPanelSet] = None):
        self.tdb = tdb
        self.device = torch.device(device)
        if panels is None:
            if budget_bytes is None:
                budget_bytes = panel_budget(self.device)
            panels = TorchPanelSet(tdb, self.device, budget_bytes)
        self.panels = panels
        self.keys = np.asarray(tdb.keys, dtype=np.int64)
        self.tlens = np.asarray(tdb.lengths(), dtype=np.int64)
        # the device top-k breaks score ties by panel row; that matches the
        # host lexsort((key, -score)) tie order only when keys ascend with
        # entry order (true for createdb output; subdbs may differ) —
        # otherwise a tied smaller-key hit past k could be dropped, so the
        # per-piece top-k path is disabled then
        self.keys_monotonic = bool(np.all(np.diff(self.keys) >= 0))
        logger.info(
            "ungapped prefilter: %d buckets (lt %s), %.1f MB panels on %s, "
            "%d splits", len(self.panels.buckets),
            [b.lt_pad for b in self.panels.buckets],
            self.panels.total_bytes / 1e6, self.device,
            len(self.panels.splits))

    def query(self, q_ss: np.ndarray, params: SearchParams) -> List[tuple]:
        """[(target_key, score)] of one query, gated and sorted by the
        reference's rules (the index server's `query` command)."""
        return self.query_batch([q_ss], params)[0]

    def query_batch(self, seqs: Sequence[np.ndarray],
                    params: SearchParams) -> List[List[tuple]]:
        """[(target_key, score)] per query, gated and sorted by the
        reference's rules; one kernel launch per (query stack, panel
        piece)."""
        profs, biases = [], []
        with span("prefilter.profiles"):
            for q_ss in seqs:
                p, b = make_query_profile(q_ss)
                profs.append(p)
                biases.append(b)
        return self._run_batch(profs, biases, params)

    def query_profile(self, prof_ss: np.ndarray,
                      params: SearchParams) -> List[tuple]:
        """Prefilter with a prebuilt [21, L] 3Di profile (profile searches;
        the reference's GPU path feeds the PSSM to its gapless kernel the
        same way, ungappedprefilter.cpp:135-199)."""
        return self.query_profiles([prof_ss], params)[0]

    def query_profiles(self, profs_ss: Sequence[np.ndarray],
                       params: SearchParams) -> List[List[tuple]]:
        """`query_profile` for several profiles as one stack: one kernel
        launch a panel piece for all of them."""
        profs = [np.asarray(p, dtype=np.float32) for p in profs_ss]
        return self._run_batch(
            profs, [abs(min(int(p.min()), 0)) for p in profs], params)

    def _run_batch(self, profs, byte_biases, params: SearchParams):
        kept = self.select(profs, byte_biases, params)
        with span("prefilter.merge"):
            return [list(zip(kk.tolist(), s.tolist())) for s, kk in kept]

    def select(self, profs, byte_biases, params: SearchParams):
        """Every query's kept candidates as (int64 scores, int64 keys), in
        the reference's order: the scan, then the gate (score above
        MIN_DIAG_SCORE and the coverage pre-gate) and the `max_seqs` best by
        (score desc, key asc). The sharded prefilter selects each rank's
        rows with it before the ranks' lists merge."""
        cands = self.scan(profs, byte_biases, params.max_seqs)
        out = []
        with span("prefilter.merge"):
            for g, (s, idx) in enumerate(cands):
                ok = s > MIN_DIAG_SCORE
                if params.cov_thr > 0.0:
                    # Util::canBeCovered length pre-gate
                    # (ungappedprefilter.cpp:403 applies it per target
                    # before scoring; host-side masking before the final
                    # top-k keeps the same surviving set)
                    qlen = profs[g].shape[1]
                    ok &= can_be_covered_mask(params.cov_thr,
                                              params.cov_mode, qlen,
                                              self.tlens[idx])
                s, kk = s[ok], self.keys[idx[ok]]
                order = np.lexsort((kk, -s))[: params.max_seqs]
                out.append((s[order], kk[order]))
        return out

    def scan(self, profs, byte_biases, max_seqs: int):
        """Every query's ungapped candidates before any gate: (int64 scores,
        int64 DB entry indices) per query, all targets where a piece brings
        its full score rows home and each piece's `max_seqs` best where it
        takes the device top-k. Spans: `prefilter.profiles` (the stacks'
        upload), `prefilter.launches` (the launches, each of which first
        brings its stack's lengths and ranges home and so waits for the
        launch before it), `prefilter.readback` (a split's copy home, which
        waits for its last launches) and `prefilter.merge`."""
        with span("prefilter.profiles"):
            stacks = make_profile_stacks(profs, byte_biases, self.device)
        nq = len(profs)
        cand_scores = [[] for _ in range(nq)]
        cand_idx = [[] for _ in range(nq)]
        multi_split = len(self.panels.splits) > 1

        for split in self.panels.splits:
            pending = []   # (query indices, n_real, entry_idx, scores, rows)
            with span("prefilter.launches"):
                for piece in split:
                    bucket = self.panels.buckets[piece.bucket]
                    rows = piece.row_end - piece.row_start
                    n_real = min(bucket.n, piece.row_end) - piece.row_start
                    if n_real <= 0:
                        continue
                    t_dev = self.panels.device_panel(piece,
                                                     keep=not multi_split)
                    entry_idx = bucket.entry_idx[
                        piece.row_start: piece.row_start + n_real]
                    use_topk = self.keys_monotonic and rows >= max(
                        DEVICE_TOPK_MIN_ROWS, 2 * max_seqs)
                    for grp, prof, q_off, caps in stacks:
                        if use_topk:
                            s, r = gapless_topk_batch(prof, q_off, caps,
                                                      t_dev,
                                                      min(rows, max_seqs))
                            pending.append((grp, n_real, entry_idx, s,
                                            r.to(torch.int32)))
                        else:
                            pending.append((grp, n_real, entry_idx,
                                            gapless_scores_batch(
                                                prof, q_off, caps, t_dev),
                                            None))
            # one copy to the host per split; a streamed split's panels are
            # released when the next split replaces them
            blocks = [x for p in pending for x in p[3:] if x is not None]
            with span("prefilter.readback"):
                flat = (torch.cat([b.reshape(-1) for b in blocks]).cpu()
                        .numpy() if blocks else None)
            off = 0

            def take(block):
                nonlocal off
                out = flat[off: off + block.numel()].reshape(block.shape)
                off += block.numel()
                return out

            with span("prefilter.merge"):
                for grp, n_real, entry_idx, s_dev, r_dev in pending:
                    s = take(s_dev)
                    if r_dev is None:
                        for r, g in enumerate(grp):
                            cand_scores[g].append(s[r][:n_real])
                            cand_idx[g].append(entry_idx)
                    else:
                        ti = take(r_dev)
                        for r, g in enumerate(grp):
                            ok = ti[r] < n_real
                            cand_scores[g].append(s[r][ok])
                            cand_idx[g].append(entry_idx[ti[r][ok]])

        empty = np.zeros(0, dtype=np.int64)
        with span("prefilter.merge"):
            return [(np.concatenate(cand_scores[g]).astype(np.int64),
                     np.concatenate(cand_idx[g]).astype(np.int64))
                    if cand_scores[g] else (empty, empty) for g in range(nq)]


def resident_prefilter(tdb: StructDB, device: torch.device) -> UngappedPrefilter:
    """UngappedPrefilter over the DB's resident panels: repeated searches
    against the same target DB on the same device reuse them."""
    return UngappedPrefilter(tdb, device, panels=resident_panels(tdb, device))


def ungapped_prefilter(qdb: StructDB, tdb: StructDB, params: SearchParams,
                       device: torch.device) -> Dict[int, List[int]]:
    pref = resident_prefilter(tdb, device)
    seqs = [np.asarray(qdb.get_ss(qi)) for qi in range(qdb.size)]
    hits = pref.query_batch(seqs, params)
    with span("prefilter.merge"):
        out: Dict[int, List[int]] = {
            int(qdb.keys[qi]): [k for k, _ in hits[qi]]
            for qi in range(qdb.size)}
    logger.info("ungapped prefilter: %d queries, avg %.1f hits",
                qdb.size, np.mean([len(v) for v in out.values()]) if out else 0)
    return out


# the reference's seqId estimate from score per aligned residue when no
# backtrace exists (Matcher::estimateSeqIdByScorePerCol)
SEQID_SLOPE, SEQID_OFFSET = 0.1656, 0.1141
# device bytes one (query, target) pair of mode 3 takes in `sw_scores_pairs`:
# its plan entries (int64 offset, int32 length, their int64 sum in the
# wrapper's range check) and its three int32 results, plus the survivor mask
# and index
MODE3_BYTES_PER_PAIR = 8 + 4 + 8 + 3 * 4 + 1 + 8


def mode3_profile(q_ss: np.ndarray) -> np.ndarray:
    """int32 [21, L] 3Di profile of `--prefilter-mode 3`: the prefilter's
    matrix (bit scale 2.0) plus its composition bias."""
    m3 = mat3di(2.0, 0.0)
    q_ss = np.asarray(q_ss)
    bias = calc_comp_bias(q_ss, m3.scores, m3.p_back, PREFILTER_BIAS_SCALE)
    return m3.scores[:, q_ss].astype(np.int32) + bias[None, :].astype(np.int32)


def sw_scores_all_targets(profs_ss, panels: TorchPanelSet, gap_open: int,
                          gap_extend: int):
    """3Di-only SW (score, q_end, t_end) int32 [q, n] device tensors of every
    query profile against every target of the DB: one `sw_scores_pairs`
    launch, or one per group of queries when the pairs' plan and results
    exceed the device-memory budget."""
    dev = panels.device
    n = panels.n_entries
    res_aa, res_ss = panels.residues()
    # the pairs are regular (every query against every target): their plan
    # is built on the device that runs the scan
    toff = torch.tensor(panels.offsets[:-1]).to(dev)
    tlen = torch.from_numpy(np.diff(panels.offsets)).to(dev)
    budget = panel_budget(dev)
    per_launch = len(profs_ss) if budget is None else max(
        1, budget // max(1, MODE3_BYTES_PER_PAIR * n))
    outs = []
    for g in range(0, len(profs_ss), per_launch):
        group = profs_ss[g: g + per_launch]
        # the AA profile is all zeros: any target AA letter scores 0
        paa, pss, slot_off = pack_sw_slots(
            [np.zeros_like(p) for p in group], group)
        pair_start = np.arange(len(group) + 1, dtype=np.int64) * n
        out = sw_scores_pairs(
            torch.from_numpy(paa).to(dev), torch.from_numpy(pss).to(dev),
            slot_off, pair_start, res_aa, res_ss, toff.repeat(len(group)),
            tlen.repeat(len(group)), gap_open, gap_extend)
        outs.append(torch.stack(out).reshape(3, len(group), n))
    return torch.cat(outs, dim=1)


def _mode3_records(q_ss, qkey: int, ti, s, qes, tes, tkeys, tlens,
                   ev: EvalueComputer, params: SearchParams,
                   same_db: bool) -> List[AlnResult]:
    """One query's mode-3 records from its survivors (target indices `ti`,
    scores `s`, end positions `qes`, `tes`): E-value gate, order, cut."""
    with span("mode3.evalues"):
        lam, mu = ev.predict_lambda_mu(q_ss)
        distinct, inverse = np.unique(s, return_inverse=True)
        evalue = np.array([ev.evalue_corr(int(v), lam, mu)
                           for v in distinct], dtype=np.float64)[inverse]
    with span("mode3.order"):
        ok = evalue <= params.evalue_thr
        if same_db:
            ok |= tkeys[ti] == qkey
        ok = np.nonzero(ok)[0]
        # compare_hits: (evalue, -score, t_len, db_key)
        order = ok[np.lexsort((tkeys[ti[ok]], tlens[ti[ok]], -s[ok],
                               evalue[ok]))][: params.max_seqs]
    results = []
    with span("mode3.records"):
        for j in order.tolist():
            sc, qe, te = int(s[j]), int(qes[j]), int(tes[j])
            seq_id = min(1.0, max(0.0, sc / float(max(qe, te, 1))
                                  * SEQID_SLOPE + SEQID_OFFSET))
            results.append(AlnResult(
                db_key=int(tkeys[ti[j]]), score=sc, seq_id=seq_id,
                evalue=float(evalue[j]), q_start=0, q_end=qe,
                q_len=len(q_ss), t_start=0, t_end=te,
                t_len=int(tlens[ti[j]]), backtrace=""))
    return results


def ungapped_and_gapped_results(qdb: StructDB, tdb: StructDB,
                                params: SearchParams, same_db: bool,
                                device: torch.device) -> Dict[int, List]:
    """--prefilter-mode 3 (PREF_MODE_UNGAPPED_AND_GAPPED): alignment-format
    results straight from the prefilter pass, skipping the alignment module
    (reference: lib/mmseqs/src/prefiltering/ungappedprefilter.cpp:274-291 —
    the GPU path where the gapped SW supplies score + end positions and
    results carry qStart=dbStart=0, the estimated seqId, no backtrace).

    Every query's 3Di profile is scored against the whole target DB by the
    SW kernel. The survivors (same-DB identity hits and scores above
    MIN_DIAG_SCORE) are selected on the device; on the host they are gated
    by E-value, sorted by (evalue, -score, t_len, key) and cut at max_seqs
    with array operations, and only the kept hits become AlnResult records.
    E-values come from the foldseek E-value network through the scalar
    `evalue_corr`, once per distinct score of a query, so the gate and the
    order see the same doubles as a per-hit loop would."""
    device = torch.device(device)
    qkeys = np.asarray(qdb.keys, dtype=np.int64)
    seqs = [np.asarray(qdb.get_ss(qi)) for qi in range(qdb.size)]
    if tdb.size == 0 or not seqs:
        return {int(k): [] for k in qkeys}
    panels = resident_panels(tdb, device)
    ev = EvalueComputer(tdb.total_residues)
    tkeys = np.asarray(tdb.keys, dtype=np.int64)
    tlens = np.diff(panels.offsets)
    with span("sw_scoring"):
        score, q_end, t_end = sw_scores_all_targets(
            [mode3_profile(s) for s in seqs], panels, params.gap_open,
            params.gap_extend)
        keep = score > MIN_DIAG_SCORE
        if same_db:
            keys_dev = torch.from_numpy(tkeys).to(device)
            keep |= (keys_dev[None, :]
                     == torch.from_numpy(qkeys).to(device)[:, None])
        hit_q, hit_t = (x.cpu().numpy() for x in keep.nonzero(as_tuple=True))
        hit_s, hit_qe, hit_te = (x[keep].cpu().numpy().astype(np.int64)
                                 for x in (score, q_end, t_end))
    out: Dict[int, List] = {}
    with span("host_loop"):
        bounds = np.searchsorted(hit_q, np.arange(qdb.size + 1))
        for qi, q_ss in enumerate(seqs):
            sel = slice(bounds[qi], bounds[qi + 1])
            out[int(qkeys[qi])] = _mode3_records(
                q_ss, int(qkeys[qi]), hit_t[sel], hit_s[sel], hit_qe[sel],
                hit_te[sel], tkeys, tlens, ev, params, same_db)
    logger.info("ungapped+gapped prefilter: %d queries x %d targets, avg "
                "%.1f hits", qdb.size, tdb.size,
                np.mean([len(v) for v in out.values()]))
    return out
